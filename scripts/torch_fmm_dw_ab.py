"""Device ms of kernel 12 (the fused 1x1-conv + BN weight gradient) in
bfloat16 at ResNet-50's representative launch, (401408, 64, 256) with
the prologue, in the tree given as argv[1] (its own ops.fused_block):
CUDA events over 50 calls cycling two input sets of 0.46 GB each, after
5 warm-up calls.  The wrapper's fixed-order sum of the float32 partials
is inside the time.  Needs one CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_fmm_dw_ab.py $t
    done
"""
import os
import sys

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import fused_block as fb  # noqa

assert fb.__file__.startswith(tree), fb.__file__
dev = torch.device("cuda", 0)
m, k, n = 128 * 56 * 56, 64, 256
gen = torch.Generator(device=dev).manual_seed(0)


def rnd(*shape):
    return torch.randn(shape, generator=gen, device=dev)


sets = []
for _ in range(2):
    x = (rnd(m, k) * 0.5).bfloat16()
    w = (rnd(k, n) * k ** -0.5).bfloat16()
    scale = torch.rand(k, generator=gen, device=dev) + 0.5
    bias = rnd(k) * 0.2
    y = (rnd(m, n) * 0.5).bfloat16()
    dy = (rnd(m, n) * 0.1).bfloat16()
    sets.append((x, w, scale, bias, y, dy, rnd(n) * 0.01, rnd(n) * 0.001))
for i in range(5):
    fb.fused_matmul_bn_dw(*sets[i % 2])
torch.cuda.synchronize()
a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
a.record()
for i in range(50):
    fb.fused_matmul_bn_dw(*sets[i % 2])
b.record()
torch.cuda.synchronize()
print(f"{sys.argv[1]}: fused_matmul_bn_dw bfloat16 ({m}, {k}, {n}) "
      f"prologue {a.elapsed_time(b) / 50:.6f} ms a call", flush=True)
