"""Device ms of the flash forward at (32, 8, 1024, 64) causal bf16 with a
float32 o, in the tree given as argv[1] (its own ops.flash_attention),
CUDA events over 200 calls cycling two input sets.  Needs one CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_flash_fwd_ab.py $t
    done
"""
import os
import sys

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import flash_attention as fa  # noqa

assert fa.__file__.startswith(tree), fa.__file__
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
sets = []
for _ in range(2):
    q, k, v = (torch.randn(32, 1024, 8, 64, generator=gen, device=dev)
               .mul(m).to(torch.bfloat16).transpose(1, 2)
               for m in (0.5, 0.5, 1.0))
    sets.append((q, k, v))
for i in range(10):
    fa.flash_fwd(*sets[i % 2], causal=True, out_dtype=torch.float32)
torch.cuda.synchronize()
a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
a.record()
for i in range(200):
    fa.flash_fwd(*sets[i % 2], causal=True, out_dtype=torch.float32)
b.record()
torch.cuda.synchronize()
print(f"{sys.argv[1]}: flash_fwd {a.elapsed_time(b) / 200:.6f} ms a call")
