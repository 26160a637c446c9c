"""Device ms of the float32 instances of kernel 10 (the fused 1x1-conv +
BN forward) at ResNet-50's representative launch, (M, K, N) = (401408,
64, 256) with the prologue, and of kernel 13 (the fused 3x3-conv + BN
forward) at (128, 56, 56, 64 -> 64) with the prologue, in the tree given
as argv[1] (its own ops.fused_block and ops.fused_conv), over 50 calls
each cycling two input sets larger than L2 (kernel 10: 0.1 GB of x a
set, 0.4 GB of y written a call; kernel 13: 0.1 GB of x, 0.1 GB of y),
after 5 warm-up calls: the device time per call from the profiler's
trace (the durations of the kernels the calls ran, as chip_smoke.py's
phase 3 takes it) and the CUDA-event stream time (host gaps included).
Each wrapper's sum of its float32 partial rows of s1 and s2 is inside
both times.  Prints the card's name and power limit first.  Needs one
CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_f32_fwd_ab.py $t
    done
"""
import os
import subprocess
import sys

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import fused_block as fb  # noqa
from incubator_mxnet_tpu_torch.ops import fused_conv as fc  # noqa

assert fc.__file__.startswith(tree) and fb.__file__.startswith(tree)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)


def rnd(*shape):
    return torch.randn(shape, generator=gen, device=dev)


def times_ms(fn, sets, iters=50, warmup=5):
    """``"device <ms> stream <ms>"`` per call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return (f"device {device_us / 1e3 / iters:.6f} stream "
            f"{a.elapsed_time(b) / iters:.6f}")


m, k, n = 401408, 64, 256
fmm_sets = []
for _ in range(2):
    scale = torch.rand(k, generator=gen, device=dev) + 0.5
    fmm_sets.append((rnd(m, k) * 0.5, rnd(k, n) * k ** -0.5, scale,
                     rnd(k) * 0.2))
print(f"{sys.argv[1]}: fused_matmul_bn_fwd float32 ({m}, {k}, {n}) prologue "
      f"{times_ms(fb.fused_matmul_bn_fwd, fmm_sets)} ms a call", flush=True)
del fmm_sets

n, h, w, c, co = 128, 56, 56, 64, 64
conv_sets = []
for _ in range(2):
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    conv_sets.append((rnd(n, h, w, c) * 0.5,
                      rnd(3, 3, c, co) * (9 * c) ** -0.5, scale,
                      rnd(c) * 0.2))
print(f"{sys.argv[1]}: fused_conv3_bn_fwd float32 ({n}, {h}, {w}, {c}, {co}) "
      f"prologue {times_ms(fc.fused_conv3_bn_fwd, conv_sets)} ms a call",
      flush=True)
