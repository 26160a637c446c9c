"""Device ms of kernel 14 (the fused 3x3-conv + BN dx) in bfloat16 at
ResNet-50's representative launch, (128, 56, 56, 64 -> 64) with the
prologue, and of kernel 10 (the fused 1x1-conv + BN forward) in bfloat16
at its representative launch, (M, K, N) = (401408, 64, 256) with the
prologue, in the tree given as argv[1] (its own ops.fused_conv and
ops.fused_block), over 50 calls each cycling two input sets larger than
L2 (kernel 14: 0.31 GB of x, y and dy a set; kernel 10: 0.05 GB of x,
0.21 GB of y written), after warm-up calls: the device time per call
from the profiler's trace (the durations of the kernels the calls ran,
as chip_smoke.py's phase 3 takes it) and the CUDA-event stream time
(host gaps included).  Each wrapper's sum of its partial rows is inside
both times.  Needs one CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_conv3_dx_fmm_fwd_ab.py $t
    done
"""
import os
import sys

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import fused_block as fb  # noqa
from incubator_mxnet_tpu_torch.ops import fused_conv as fc  # noqa

assert fc.__file__.startswith(tree) and fb.__file__.startswith(tree)
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)


def rnd(*shape):
    return torch.randn(shape, generator=gen, device=dev)


def times_ms(fn, sets, iters, warmup):
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


n, h, w, c, co = 128, 56, 56, 64, 64
conv_sets = []
for _ in range(2):
    x = (rnd(n, h, w, c) * 0.5).bfloat16()
    k = (rnd(3, 3, c, co) * (9 * c) ** -0.5).bfloat16()
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    conv_sets.append((x, k, scale, rnd(c) * 0.2,
                      (rnd(n, h, w, co) * 0.5).bfloat16(),
                      (rnd(n, h, w, co) * 0.1).bfloat16(), rnd(co) * 0.01,
                      rnd(co) * 0.001))
print(f"{sys.argv[1]}: fused_conv3_bn_dx bfloat16 ({n}, {h}, {w}, {c}, {co}) "
      f"prologue {times_ms(fc.fused_conv3_bn_dx, conv_sets, 50, 5)} ms a "
      "call", flush=True)
del conv_sets

m, k_, n_ = 401408, 64, 256
fmm_sets = []
for _ in range(2):
    x = (rnd(m, k_) * 0.5).bfloat16()
    wt = (rnd(k_, n_) * k_ ** -0.5).bfloat16()
    scale = torch.rand(k_, generator=gen, device=dev) + 0.5
    fmm_sets.append((x, wt, scale, rnd(k_) * 0.2))
print(f"{sys.argv[1]}: fused_matmul_bn_fwd bfloat16 ({m}, {k_}, {n_}) "
      f"prologue {times_ms(fb.fused_matmul_bn_fwd, fmm_sets, 50, 5)} ms a "
      "call", flush=True)
