"""Device ms of kernel 9 (the RMSNorm backward, with its partials' sum)
at the TransformerLM's rows, (32768, 512) bfloat16, and of kernel 1 (the
LayerNorm forward) at BERT's serving rows, (1024, 768), in float32 and
bfloat16, and at its training rows, (2048, 768), in bfloat16 with
float32 gamma and beta (as amp leaves them), in the tree given as
argv[1] (its own ops.rms_norm and ops.layer_norm), through the wrappers
a model calls.  Each is timed over 200 calls cycling input sets larger
than L2 (kernel 9: 4 sets, 128 MiB of x and g; kernel 1: at least 24
sets and 72 MiB of x), after 20 warm-up calls: the device time per call
from the profiler's trace (the durations of the kernels the calls ran,
as chip_smoke.py's phase 3 takes it), each kernel's share of it by name,
and the CUDA-event stream time (host gaps included).  Where the tree's
modules plan their grids in Python, the other plans are timed too: the
RMSNorm backward at 2, 3 and 4 blocks an SM, the LayerNorm forward at
4 and 8 warps a block.  Prints the card's name and power limit first.
Needs one CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_rows_ab.py $t
    done
"""
import os
import subprocess
import sys

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import layer_norm as ln  # noqa
from incubator_mxnet_tpu_torch.ops import rms_norm as rn  # noqa

assert ln.__file__.startswith(tree) and rn.__file__.startswith(tree)
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)


def times_ms(fn, sets, iters=200, warmup=20):
    """``"device <ms> stream <ms> (<kernel> <ms>, ...)"`` per call of
    ``fn``; each kernel named without its template arguments and
    parameters."""
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
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name[5:] if name.startswith("void ") else name
            name = name.split("<")[0].split("(")[0].split("::")[-1]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    device_ms = sum(by_name.values()) / 1e3 / iters
    shares = ", ".join(f"{k} {v / 1e3 / iters:.6f}"
                       for k, v in sorted(by_name.items()))
    return (f"device {device_ms:.6f} stream "
            f"{a.elapsed_time(b) / iters:.6f} ({shares})")


rows, cols = 32768, 512
rms_sets = []
for _ in range(4):
    x = (torch.randn(rows, cols, generator=gen, device=dev) * 2 + 0.3).to(
        torch.bfloat16)
    gamma = (torch.rand(cols, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    g = torch.randn(rows, cols, generator=gen, device=dev).to(torch.bfloat16)
    rms_sets.append((x, g, gamma, rn.rms_norm_fwd_reference(x, gamma)[1]))
plans = [None]
if hasattr(rn, "_BWD_BLOCKS_PER_SM"):
    chosen = rn._BWD_BLOCKS_PER_SM
    plans = [chosen] + [k for k in (2, 3, 4) if k != chosen]
for per_sm in plans:
    note = ""
    if per_sm is not None:
        rn._BWD_BLOCKS_PER_SM = per_sm
        note = f", {per_sm} blocks an SM"
    print(f"{sys.argv[1]}: rms_norm_bwd ({rows}, {cols}) bfloat16{note} "
          f"{times_ms(rn.rms_norm_bwd, rms_sets)} ms a call", flush=True)
if per_sm is not None:
    rn._BWD_BLOCKS_PER_SM = chosen
del rms_sets


def ln_sets(rows, dtype, pdtype):
    cols = 768
    n = max(24, -(-(72 << 20) // (rows * cols * dtype.itemsize)))
    sets = []
    for _ in range(n):
        x = (torch.randn(rows, cols, generator=gen, device=dev) * 2 + 0.5).to(
            dtype)
        gamma = 1 + 0.1 * torch.randn(cols, generator=gen, device=dev)
        beta = 0.1 * torch.randn(cols, generator=gen, device=dev)
        sets.append((x, gamma.to(pdtype), beta.to(pdtype)))
    return sets


warps = [None]
if hasattr(ln, "_FWD_WARPS"):
    chosen_warps = ln._FWD_WARPS
    warps = [chosen_warps] + [w for w in (4, 8) if w != chosen_warps]
for rows, dtype, pdtype in ((1024, torch.float32, torch.float32),
                            (1024, torch.bfloat16, torch.bfloat16),
                            (1024, torch.bfloat16, torch.float32),
                            (2048, torch.bfloat16, torch.float32)):
    sets = ln_sets(rows, dtype, pdtype)
    for w in warps:
        note = ""
        if w is not None:
            ln._FWD_WARPS = w
            note = f", {w} warps a block"
        print(f"{sys.argv[1]}: layer_norm_fwd ({rows}, 768) "
              f"{str(dtype)[6:]}, gamma/beta {str(pdtype)[6:]}{note} "
              f"{times_ms(ln.layer_norm_fwd, sets)} ms a call", flush=True)
    if w is not None:
        ln._FWD_WARPS = chosen_warps
    del sets
