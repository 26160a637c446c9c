"""Device ms of kernel 2 (the LayerNorm backward) in float32 at BERT-base's
training rows, (2048, 768), and of kernel 16 (the fused 3x3-conv + BN
weight gradient) in bfloat16 at ResNet-50's representative launch,
(128, 56, 56, 64 -> 64) with the prologue, in the tree given as argv[1]
(its own ops.layer_norm and ops.fused_conv), over 200 calls of kernel 2
cycling 24 input sets (144 MiB) and 50 calls of kernel 16 cycling two
input sets of 0.15 GB each, after warm-up calls: the device time per
call from the profiler's trace (the durations of the kernels the calls
ran, as chip_smoke.py's phase 3 takes it) and the CUDA-event stream
time (host gaps included: kernel 2's call is shorter than its Python
wrapper).  Each wrapper's sum of its partials is inside both times.
Needs one CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_ln_conv3_dw_ab.py $t
    done
"""
import os
import sys

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import fused_conv as fc  # noqa
from incubator_mxnet_tpu_torch.ops import layer_norm as ln  # noqa

assert fc.__file__.startswith(tree) and ln.__file__.startswith(tree)
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


rows, cols = 2048, 768
ln_sets = []
for _ in range(24):
    x = rnd(rows, cols) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * rnd(cols)
    _, mean, rstd = ln.layer_norm_fwd_reference(x, gamma, torch.zeros_like(
        gamma))
    ln_sets.append((x, rnd(rows, cols), gamma, mean, rstd))
print(f"{sys.argv[1]}: layer_norm_bwd float32 ({rows}, {cols}) "
      f"{times_ms(ln.layer_norm_bwd, ln_sets, 200, 20)} ms a call",
      flush=True)
del ln_sets

n, h, w, c, co = 128, 56, 56, 64, 64
conv_sets = []
for _ in range(2):
    x = (rnd(n, h, w, c) * 0.5).bfloat16()
    k = (rnd(3, 3, c, co) * (9 * c) ** -0.5).bfloat16()
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = rnd(c) * 0.2
    y = (rnd(n, h, w, co) * 0.5).bfloat16()
    dy = (rnd(n, h, w, co) * 0.1).bfloat16()
    conv_sets.append((x, k, scale, bias, y, dy, rnd(co) * 0.01,
                      rnd(co) * 0.001))
print(f"{sys.argv[1]}: fused_conv3_bn_dw bfloat16 ({n}, {h}, {w}, {c}, {co}) "
      f"prologue {times_ms(fc.fused_conv3_bn_dw, conv_sets, 50, 5)} ms a "
      "call", flush=True)
