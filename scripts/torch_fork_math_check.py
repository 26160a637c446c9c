#!/usr/bin/env python3
"""Does forking before torch's first CPU math change later float32 results?

Runs a small float32 TransformerLM forward (seeded weights, the port's
CPU path) in fresh processes: once with no fork (the reference), then N
times after the process forked 20 children before its first torch op,
with and without ``gluon/data/dataloader.py``'s ``_start_cpu_math`` run
first, and counts the processes whose logits differ from the reference.

    python scripts/torch_fork_math_check.py [N]

On this repository's CPU sandbox (torch 2.13 with MKL) about a quarter
of the cold-fork processes differ, in one batch row of the attention's
exp, and none of the warmed ones.
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r"""
import os, sys, numpy as np, torch
sys.path.insert(0, %r)
from incubator_mxnet_tpu_torch.gluon.data import dataloader
from incubator_mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                          TransformerLM)
mode = sys.argv[1]
if mode == "warm":
    dataloader._start_cpu_math()
if mode != "none":
    for _ in range(20):
        pid = os.fork()
        if pid == 0:
            os._exit(0)
        os.waitpid(pid, 0)
cfg = TransformerConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, max_len=64, dtype="float32")
model = TransformerLM(cfg).init(device="cpu")
tokens = torch.from_numpy(np.random.default_rng(0).integers(
    0, 256, (8, 32)).astype(np.int32))
with torch.no_grad():
    sys.stdout.buffer.write(model(tokens).float().numpy().tobytes())
""" % ROOT


def run(mode):
    out = subprocess.run([sys.executable, "-c", CHILD, mode],
                         capture_output=True, check=True).stdout
    return np.frombuffer(out, np.float32)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    ref = run("none")
    for mode in ("cold", "warm"):
        bad = sum(not np.array_equal(run(mode), ref) for _ in range(n))
        print(f"{mode} fork: {bad} of {n} processes differ from the "
              "reference", flush=True)


if __name__ == "__main__":
    main()
