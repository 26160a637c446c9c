"""Device ms of kernel 3 (the softmax forward) and kernel 6 (the softmax
cross-entropy forward) in the tree given as argv[1] (its own ops.softmax
and ops.softmax_xent), through the wrappers a model calls: kernel 3 at
SSD.detections' class rows, (3816832, 21), in float32 and bfloat16, and
at the TransformerLM's attention rows, (262144, 1024) float32; kernel 6
at the LSTM LM's logits, (1120, 10000), and BERT's MLM logits, (2048,
30522), in float32 and bfloat16, and at LeNet's (64, 10) float32.  Each
shape is timed over 200 calls cycling input sets of at least 96 MiB in
all (twice L2; (64, 10): 24 sets), after 20 warm-up calls: the device
time per call from the profiler's trace (the durations of the kernels
the calls ran), each kernel's share of it by name, and the CUDA-event
stream time (host gaps included).  The library call on the same inputs
follows each: ``torch.softmax(x, -1)``, ``F.cross_entropy(x, labels,
reduction="none")``.  Prints the card's name and power limit first.
Needs one CUDA card.

To compare two checkouts on one card, time them in turns:

    for t in ../parent . . ../parent; do
        python3 scripts/torch_softmax_ab.py $t
    done
"""
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
from incubator_mxnet_tpu_torch.ops import softmax as sm  # noqa
from incubator_mxnet_tpu_torch.ops import softmax_xent as sx  # noqa

assert sm.__file__.startswith(tree) and sx.__file__.startswith(tree)
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip(), flush=True)
SET_BYTES = 96 << 20


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


def n_sets(nbytes, least=2):
    return max(least, -(-SET_BYTES // nbytes))


for rows, cols, dtype in ((32 * 119276, 21, torch.float32),
                          (32 * 119276, 21, torch.bfloat16),
                          (262144, 1024, torch.float32)):
    sets = [((torch.randn(rows, cols, generator=gen, device=dev) * 3).to(
        dtype),) for _ in range(n_sets(rows * cols * dtype.itemsize))]
    label = f"{sys.argv[1]}: softmax_fwd ({rows}, {cols}) {str(dtype)[6:]}"
    print(f"{label} {times_ms(sm.softmax_fwd, sets)} ms a call", flush=True)
    print(f"{label} library torch.softmax(x, -1) "
          f"{times_ms(lambda x: torch.softmax(x, -1), sets)} ms a call",
          flush=True)
    del sets

for rows, cols, dtype in ((1120, 10000, torch.float32),
                          (1120, 10000, torch.bfloat16),
                          (2048, 30522, torch.float32),
                          (2048, 30522, torch.bfloat16),
                          (64, 10, torch.float32)):
    count = (24 if cols < 1024 else
             n_sets(rows * cols * dtype.itemsize, least=3))
    sets = []
    for _ in range(count):
        x = (torch.randn(rows, cols, generator=gen, device=dev) * 3).to(dtype)
        labels = torch.randint(0, cols, (rows,), generator=gen, device=dev,
                               dtype=torch.int32)
        sets.append((x, labels))
    label = (f"{sys.argv[1]}: softmax_xent_fwd ({rows}, {cols}) "
             f"{str(dtype)[6:]}")
    print(f"{label} {times_ms(sx.softmax_xent_fwd, sets)} ms a call",
          flush=True)
    lib_sets = [(x, labels.long()) for x, labels in sets]
    print(f"{label} library F.cross_entropy "
          f"{times_ms(lambda x, lbl: F.cross_entropy(x, lbl, reduction='none'), lib_sets)}"
          " ms a call", flush=True)
    del sets, lib_sets
