#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``incubator_mxnet_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises, prints its traceback and exits non-zero):

1. device — require CUDA; print the card's name and power limit and the
   TF32 flags (both set off: float32 stays float32);
2. build — compile every kernel from ``incubator_mxnet_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once);
3. kernels — each kernel against its plain PyTorch version on the card
   at the main path's shapes, with the stated tolerances, and its time
   beside the plain version's, one PyTorch library call's and the bound;
4. BERT-base at full width in process — one forward at B=8, T=128 on
   the card against the same weights on the CPU through the port's
   plain path, and the LayerNorm launch count of that forward;
5. serve — export, ``InferenceServer`` on an ephemeral port with
   buckets 1,2,4,8, 8 HTTP predictions (3 in turn, 5 at once) each
   checked against a direct ``Predictor`` call;
6. the kernels line (JSON), then the last line
   ``{"ok": true, "device": {...}}``.

Launch counters are set to 0 just before phase 4 and read after phase
5, so the kernels line counts only the main path's launches.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

B, T = 8, 128
BUCKETS = [1, 2, 4, 8]
VALID = [128, 100, 77, 64, 33, 16, 5, 1]
HIDDEN = 768
LN_SHAPES = [((B * T // 8, HIDDEN), "float32"),
             ((B * T // 4, HIDDEN), "float32"),
             ((B * T // 2, HIDDEN), "float32"),
             ((B * T, HIDDEN), "float32"),
             ((B * T, HIDDEN), "bfloat16"),
             ((1000, 100), "float32"),
             ((3, 4096), "bfloat16")]
LN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # on y; stats always 1e-5
STAT_TOL = 1e-5


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def memory_rate(name):
    """Device-memory bytes/s of the SKU, from its published data sheet."""
    if "H200" in name:
        return 4.8e12, "H200: 4.8 TB/s"
    if "NVL" in name:
        return 3.9e12, "H100 NVL: 3.9 TB/s"
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe: 2.0 TB/s"
    return 3.35e12, "H100 SXM5: 3.35 TB/s"


def time_ms(torch, fn, argsets, iters=200, warmup=20):
    """``(device_ms, stream_ms)`` per call of ``fn`` over ``iters`` calls,
    cycling through ``argsets`` (enough distinct inputs that reads miss
    L2).  ``device_ms`` sums the durations of the kernels (and copies)
    the calls ran, from the profiler's device trace; ``stream_ms`` is
    CUDA-event time from first to last call, host gaps included.
    ``device_ms`` is None if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(*argsets[i % len(argsets)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return (device_us / 1e3 / iters if device_us else None), stream_ms


def ln_inputs(torch, shape, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * torch.randn(shape[-1], generator=g)
    beta = 0.1 * torch.randn(shape[-1], generator=g)
    dt = getattr(torch, dtype)
    return tuple(a.to(device, dt) for a in (x, gamma, beta))


def check_layer_norm(torch, ln, dev):
    """Kernel against plain version at every shape; returns the max
    |Δy| at the serving shape (B·T, 768) float32."""
    serving_err = None
    for shape, dtype in LN_SHAPES:
        x, g, b = ln_inputs(torch, shape, dtype, 0, dev)
        y, mean, rstd = ln.layer_norm_fwd(x, g, b)
        ry, rmean, rrstd = ln.layer_norm_fwd_reference(x, g, b)
        torch.cuda.synchronize()
        tol = LN_TOL[dtype]
        torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(mean, rmean, rtol=STAT_TOL, atol=STAT_TOL)
        torch.testing.assert_close(rstd, rrstd, rtol=STAT_TOL, atol=STAT_TOL)
        err = (y.float() - ry.float()).abs().max().item()
        print(f"layer_norm {shape} {dtype}: max|dy|={err:.3e} "
              f"max|dmean|={(mean - rmean).abs().max().item():.3e} "
              f"max|drstd|={(rstd - rrstd).abs().max().item():.3e} "
              f"(tol {tol:g}) ok", flush=True)
        if shape == (B * T, HIDDEN) and dtype == "float32":
            serving_err = err
    return serving_err


def time_layer_norm(torch, ln, dev, dtype, rate):
    """Times at the serving shape, cycling 24 input sets (72 MiB in
    float32) so that the reads come from device memory, not L2."""
    import torch.nn.functional as F
    rows, cols = B * T, HIDDEN
    sets = [ln_inputs(torch, (rows, cols), dtype, s, dev) for s in range(24)]
    times = {
        "ms": time_ms(torch, ln.layer_norm_fwd, sets),
        "plain_ms": time_ms(torch, ln.layer_norm_fwd_reference, sets),
        "library_ms": time_ms(torch, lambda x, g, b: F.layer_norm(
            x, (cols,), g, b, 1e-5), sets)}
    esize = sets[0][0].element_size()
    nbytes = rows * cols * 2 * esize + 2 * cols * esize + 2 * rows * 4
    bound = nbytes / rate * 1e3
    print(f"layer_norm ({rows}, {cols}) {dtype}: bound_ms={bound:.6f} "
          f"(bytes={nbytes}); per call, device time from the profiler "
          "trace / CUDA-event stream time:", flush=True)
    for k, (device, stream) in times.items():
        print(f"  {k}: device {device} stream {stream:.6f}", flush=True)
    out = {"bound_ms": bound}
    for k, (device, stream) in times.items():
        if device is None:
            print(f"  {k}: profiler saw no device time; reporting CUDA-"
                  "event time", flush=True)
        out[k] = device if device is not None else stream
    return out


def forward_breakdown(torch, pred, args, n):
    """Device time of one ``Predictor`` call by kernel family, from the
    profiler's trace, against the call's host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        pred(*args)
        wall_ms = (time.monotonic() - t0) * 1e3
    fams = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        fam = next((f for f in ("layer_norm", "gemm", "softmax", "memcpy")
                    if f in name), "other")
        fams[fam] = fams.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(fams.values())
    print(f"  bucket {n} profile: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; by family "
          f"(ms): {({k: round(v, 4) for k, v in sorted(fams.items())})}",
          flush=True)


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/bert:predict",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out, (time.monotonic() - t0) * 1e3


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from incubator_mxnet_tpu_torch.deploy import export_model
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops import _build, layer_norm as ln
    from incubator_mxnet_tpu_torch.serving.server import InferenceServer

    phase("1 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    rate, rate_note = memory_rate(kind)
    dev = torch.device("cuda", 0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; "
          f"memory rate assumed {rate_note}", flush=True)

    phase("2 build")
    t0 = time.monotonic()
    logs = _build.build(["layer_norm"])
    print(f"build: {time.monotonic() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})", flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                print("  " + line.strip(), flush=True)

    phase("3 kernel against plain version")
    ln_err = check_layer_norm(torch, ln, dev)
    ln_times = time_layer_norm(torch, ln, dev, "float32", rate)
    time_layer_norm(torch, ln, dev, "bfloat16", rate)

    phase("4 BERT-base in process")
    model = BERTModel().initialize(
        device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 30522, (B, T)).astype(np.int32)
    types = np.zeros((B, T), np.int32)
    for i, n in enumerate(VALID):
        types[i, n // 2:n] = 1
    valid = np.array(VALID, np.int32)
    inputs = [torch.from_numpy(a) for a in (tokens, types, valid)]
    t0 = time.monotonic()
    with torch.inference_mode():
        ref = [o.numpy() for o in model(*inputs)]
    print(f"CPU reference forward: {time.monotonic() - t0:.2f} s", flush=True)
    model.to(dev)
    ln.launches = 0                     # main path starts here
    with torch.inference_mode():
        got = model(*(a.to(dev) for a in inputs))
        torch.cuda.synchronize()
        got = [o.cpu().numpy() for o in got]
    assert ln.launches == 25, f"{ln.launches} LayerNorm launches, want 25"
    for name, g, r in zip(("mlm", "nsp"), got, ref):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        err, scale = np.abs(g - r).max(), np.abs(r).max()
        print(f"bert {name} {g.shape}: max|d|={err:.3e} "
              f"bound 1e-3*max|ref|={1e-3 * scale:.3e}", flush=True)
        assert err <= 1e-3 * scale, name
    print("LayerNorm launches in one forward: 25", flush=True)

    phase("5 serve")
    os.environ["MXNET_SERVING_MAX_LATENCY_MS"] = "20"  # let 5 at once meet
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "bert_base")
        export_model(model, [a[:1] for a in (tokens, types, valid)], prefix,
                     outputs=[1])
        del model
        server = InferenceServer(port=0, buckets=BUCKETS, device=dev)
        try:
            t0 = time.monotonic()
            server.repository.load("bert", prefix)
            print(f"load + warmup: {time.monotonic() - t0:.2f} s", flush=True)
            port = server.start()
            before = ln.launches
            bodies = [{"inputs": [tokens[i].tolist(), types[i].tolist(),
                                  int(valid[i])]} for i in range(B)]
            answers = [None] * B
            for i in range(3):
                answers[i] = post(port, bodies[i])
            barrier = threading.Barrier(B - 3)

            def send(i):
                barrier.wait()
                answers[i] = post(port, bodies[i])

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(3, B)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            entry = server.repository.get("bert")
            pred = entry.predictor
            for i, (out, _) in enumerate(answers):
                (direct,) = pred(tokens[i:i + 1], types[i:i + 1],
                                 valid[i:i + 1])
                np.testing.assert_allclose(np.asarray(out["outputs"][0]),
                                           direct[0], rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(direct[0], ref[1][i],
                                           atol=1e-3 * np.abs(ref[1]).max())
            lat = [ms for _, ms in answers]
            batches = dict(entry.batcher.batches)
            print(f"8 HTTP predictions agree with direct Predictor calls "
                  f"(rtol=atol=1e-4); batches (rows, padded_to): {batches}",
                  flush=True)
            print(f"request latency ms: p50={statistics.median(lat):.3f} "
                  f"max={max(lat):.3f} all={[round(v, 3) for v in lat]}",
                  flush=True)
            assert max(n for n, _ in batches) > 1, "no batch of 2+ formed"
            assert ln.launches > before, "serving launched no LayerNorm"
            for n in BUCKETS:
                args = [np.repeat(a[:1], n, axis=0)
                        for a in (tokens, types, valid)]
                pred(*args)
                runs = []
                for _ in range(10):
                    t0 = time.monotonic()
                    pred(*args)
                    runs.append((time.monotonic() - t0) * 1e3)
                print(f"Predictor forward bucket {n}: median "
                      f"{statistics.median(runs):.3f} ms min "
                      f"{min(runs):.3f} ms (host clock, 10 runs)",
                      flush=True)
                forward_breakdown(torch, pred, args, n)
        finally:
            server.shutdown()
    launches = ln.launches              # main path ends here

    phase("6 kernels")
    print(json.dumps({"kernels": [dict(
        name="layer_norm_fwd", route="cuda",
        source="incubator_mxnet_tpu_torch/csrc/layer_norm.cu",
        replaces="incubator_mxnet_tpu/ops/pallas_kernels.py:219",
        launches=launches, max_abs_err=ln_err, bound_by="bytes",
        **ln_times)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
