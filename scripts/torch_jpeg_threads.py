"""How nvJPEG decode scales with host threads on the card, against
``io.ImageRecordIter``, which decodes on its one producer thread.

    python scripts/torch_jpeg_threads.py [threads ...]

Decodes the photo fixtures of ``tests/fixtures/torch_jpeg`` (512 decodes
after 64 of warm-up, each into its own buffer) on 1, 2, 4 and 8 host
threads, each thread with its own nvJPEG instance and CUDA stream, and
prints img/s of each; then reads a ``.rec`` of 1024 JPEG records through
``ImageRecordIter`` (3x224x224, B=128, short side 256, random crops and
mirrors) and prints its img/s.  Needs a CUDA device; builds the two
kernels it uses.
"""
import glob
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from incubator_mxnet_tpu_torch import io, recordio  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import jpeg_decode as jd  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "torch_jpeg")


def decode_rate(bufs, dev, threads, n=512, warmup=64):
    local = threading.local()

    def work(i):
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(dev)
        buf = bufs[i % len(bufs)]
        h, w, _ = jd.jpeg_size(buf)
        out = torch.empty(h * w * 3, dtype=torch.uint8, device=dev)
        with torch.cuda.stream(stream):
            jd.decode_into(buf, out, (h, w))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(work, range(warmup)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(pool.map(work, range(n)))
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)


def iterator_rate(rec, dev):
    it = io.ImageRecordIter(rec, data_shape=(3, 224, 224), batch_size=128,
                            resize=256, rand_crop=True, rand_mirror=True,
                            shuffle=True, device=dev)
    for _ in it:          # a warm-up epoch
        pass
    it.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = sum(1 for _ in it)
    torch.cuda.synchronize()
    return batches * 128 / (time.perf_counter() - t0)


def main(argv):
    counts = [int(a) for a in argv] or [1, 2, 4, 8]
    dev = torch.device("cuda", 0)
    _build.build(["jpeg_decode", "image_batch"])
    bufs = []
    for f in sorted(glob.glob(os.path.join(FIXTURES, "photo_*.jpg"))):
        with open(f, "rb") as fh:
            bufs.append(fh.read())
    print(f"{torch.cuda.get_device_name(0)}; {os.cpu_count()} CPUs",
          flush=True)
    for n in counts:
        print(f"nvJPEG decode, {n} threads: "
              f"{decode_rate(bufs, dev, n):.1f} img/s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "t.rec")
        w = recordio.MXRecordIO(rec, "w")
        for i in range(1024):
            w.write(recordio.pack(recordio.IRHeader(0, float(i % 1000), i,
                                                    0), bufs[i % len(bufs)]))
        w.close()
        print(f"ImageRecordIter (one decode thread): "
              f"{iterator_rate(rec, dev):.1f} img/s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
