"""The port's data path from disk: ``recordio``, ``RecordFileDataset`` and
the ``DataLoader``'s thread and process workers, against the JAX
package's, on the CPU.

* ``recordio``: files written by the port and by the JAX package are
  equal byte for byte, ``.idx`` included, for records that hold the
  magic word (split into parts) and for ``pack``/``pack_raw`` records;
  each package reads the other's, sequentially and by index.
* Workers: thread and process workers give the serial loader's batches
  and the JAX loader's, with a transform and with shuffle; a worker's
  error reaches the parent; an abandoned epoch leaves no shared-memory
  segment behind; ``prefetch=0`` still yields; where only ``spawn``
  exists, an unpicklable dataset goes to threads with a warning.

Every comparison is exact: the same bytes and numpy values on both
sides.
"""
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import recordio as jax_recordio

from incubator_mxnet_tpu_torch import random, recordio
from incubator_mxnet_tpu_torch.gluon import data


def _payloads(seed=0):
    """Records of several lengths, two of them holding the magic word at
    4-byte boundaries (written in parts) and one empty."""
    rng = np.random.RandomState(seed)
    magic = (0xced7230a).to_bytes(4, "little")
    out = [rng.bytes(n) for n in (1, 3, 4, 17, 1000)]
    out.append(b"abcd" + magic + b"efgh" + magic)
    out.append(magic + b"xy")
    out.append(b"")
    hdr = recordio.IRHeader(0, 3.0, 7, 0)
    img = rng.randint(0, 256, (5, 6, 3)).astype(np.uint8)
    out.append(recordio.pack_raw(hdr, img))
    out.append(recordio.pack(recordio.IRHeader(0, [1.0, 2.5], 9, 1), b"z"))
    return out


def _write(mod, idx, rec, payloads):
    w = mod.MXIndexedRecordIO(str(idx), str(rec), "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()


def test_files_are_byte_for_byte_the_jax_packages(tmp_path):
    payloads = _payloads()
    _write(recordio, tmp_path / "a.idx", tmp_path / "a.rec", payloads)
    _write(jax_recordio, tmp_path / "b.idx", tmp_path / "b.rec", payloads)
    for ext in ("rec", "idx"):
        assert (tmp_path / f"a.{ext}").read_bytes() == (
            tmp_path / f"b.{ext}").read_bytes()
    seq = recordio.MXRecordIO(str(tmp_path / "c.rec"), "w")
    jseq = jax_recordio.MXRecordIO(str(tmp_path / "d.rec"), "w")
    for p in payloads:
        seq.write(p)
        jseq.write(p)
    seq.close()
    jseq.close()
    assert (tmp_path / "c.rec").read_bytes() == (
        tmp_path / "d.rec").read_bytes()


@pytest.mark.parametrize("writer,reader", [(recordio, jax_recordio),
                                           (jax_recordio, recordio)])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    payloads = _payloads(1)
    _write(writer, tmp_path / "x.idx", tmp_path / "x.rec", payloads)
    r = reader.MXIndexedRecordIO(str(tmp_path / "x.idx"),
                                 str(tmp_path / "x.rec"), "r")
    assert r.keys == list(range(len(payloads)))
    for i in reversed(range(len(payloads))):
        assert r.read_idx(i) == payloads[i]
    seq = reader.MXRecordIO(str(tmp_path / "x.rec"), "r")
    got = []
    while (rec := seq.read()) is not None:
        got.append(rec)
    assert got == payloads
    r.close()
    seq.close()


def test_pack_unpack_and_raw_images_match_jax():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (7, 4, 3)).astype(np.uint8)
    for label in (4.0, [1.0, 2.0, 3.5]):
        h = recordio.IRHeader(0, label, 11, 2)
        jh = jax_recordio.IRHeader(0, label, 11, 2)
        assert recordio.pack(h, b"payload") == jax_recordio.pack(jh,
                                                                 b"payload")
        assert recordio.pack_raw(h, img) == jax_recordio.pack_raw(jh, img)
        header, out = recordio.unpack_raw(jax_recordio.pack_raw(jh, img))
        np.testing.assert_array_equal(out, img)
        np.testing.assert_array_equal(header.label, jh.label)
        assert (header.id, header.id2) == (11, 2)
        header, s = recordio.unpack(recordio.pack(h, b"xyz"))
        assert s == b"xyz" and header.flag == (0 if np.isscalar(label)
                                               else 3)
    with pytest.raises(ValueError, match="HWC RGB"):
        recordio.pack_raw(recordio.IRHeader(0, 0, 0, 0), img[..., 0])
    with pytest.raises(ValueError, match="MXTR"):
        recordio.unpack_raw(recordio.pack(recordio.IRHeader(0, 0, 0, 0),
                                          b"JPEG...."))


def test_readers_survive_pickling_threads_and_forks(tmp_path):
    n = 300
    payloads = [bytes([i % 251]) * (1 + (i * 7919) % 20000)
                for i in range(n)]
    _write(recordio, tmp_path / "t.idx", tmp_path / "t.rec", payloads)
    ds = data.RecordFileDataset(str(tmp_path / "t.rec"))
    assert len(ds) == n
    clone = pickle.loads(pickle.dumps(ds))
    assert [clone[i] for i in range(n)] == payloads
    errors = []

    def read(order):
        for i in order:
            if ds[i] != payloads[i]:
                errors.append(i)

    # more threads than cores, switching often: seek and read must not
    # interleave
    threads = [threading.Thread(target=read, args=(
        list(np.random.RandomState(s).permutation(n)),))
        for s in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    # forked readers reopen the file: no offset shared with the parent
    # or with each other
    loader = data.DataLoader(ds, batch_size=10, num_workers=6,
                             thread_pool=False,
                             batchify_fn=lambda s: np.array(
                                 [len(p) for p in s], np.int64))
    for _ in range(2):
        assert torch.cat(list(loader)).tolist() == [len(p) for p in payloads]


def test_image_codec_is_not_ported_yet():
    # decoding is ported (nvJPEG on the card, cv2/PIL on the CPU); JPEG
    # encoding on the card is not, and raises naming nvJPEG's encoder
    with pytest.raises(NotImplementedError, match="nvJPEG"):
        recordio.pack_img(recordio.IRHeader(0, 0.0, 0, 0),
                          torch.empty((2, 2, 3), dtype=torch.uint8,
                                      device="meta"))
    with pytest.raises(NotImplementedError, match="item 12"):
        recordio.MXRecordIO("s3://bucket/x.rec", "r")
    with pytest.raises(ValueError, match="invalid flag"):
        recordio.MXRecordIO("x.rec", "a")


# ---------------------------------------------------------------------------
# DataLoader workers
# ---------------------------------------------------------------------------

def _dataset(n=64, shape=(3, 8, 8)):
    rng = np.random.RandomState(0)
    x = rng.rand(n, *shape).astype(np.float32)
    y = rng.randint(0, 10, (n,)).astype(np.int32)
    return x, y


def _np(batches):
    return [tuple(t.numpy() for t in b) for b in batches]


def _jnp(batches):
    return [tuple(t.asnumpy() for t in b) for b in batches]


def _double(img, lbl):
    return img * 2.0, lbl


@pytest.mark.parametrize("thread_pool", [True, False])
@pytest.mark.parametrize("num_workers", [1, 3])
def test_workers_equal_the_serial_and_the_jax_loader(thread_pool,
                                                     num_workers):
    x, y = _dataset()
    serial = _np(data.DataLoader(data.ArrayDataset(x, y).transform(_double),
                                 batch_size=10))
    got = _np(data.DataLoader(data.ArrayDataset(x, y).transform(_double),
                              batch_size=10, num_workers=num_workers,
                              thread_pool=thread_pool))
    want = _jnp(jax_gluon.data.DataLoader(
        jax_gluon.data.ArrayDataset(x, y).transform(_double), batch_size=10,
        num_workers=num_workers, thread_pool=thread_pool))
    assert len(got) == len(serial) == len(want) == 7
    for g, s, w in zip(got, serial, want):
        for a, b, c in zip(g, s, w):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("thread_pool", [True, False])
def test_workers_with_shuffle_give_the_serial_permutation(thread_pool):
    x, y = _dataset(48)
    ds = data.ArrayDataset(x, np.arange(48, dtype=np.int32))
    random.seed(5)
    serial = _np(data.DataLoader(ds, batch_size=16, shuffle=True))
    random.seed(5)
    got = _np(data.DataLoader(ds, batch_size=16, shuffle=True,
                              num_workers=2, thread_pool=thread_pool))
    for g, s in zip(got, serial):
        np.testing.assert_array_equal(g[0], s[0])
        np.testing.assert_array_equal(g[1], s[1])
    seen = np.concatenate([b[1] for b in got])
    assert sorted(seen.tolist()) == list(range(48))
    jseen = np.concatenate([b[1].asnumpy() for b in jax_gluon.data.DataLoader(
        jax_gluon.data.ArrayDataset(x, np.arange(48, dtype=np.int32)),
        batch_size=16, shuffle=True, num_workers=2,
        thread_pool=thread_pool)])
    assert sorted(jseen.tolist()) == sorted(seen.tolist())


class _Bad(data.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, idx):
        if idx == 5:
            raise ValueError("boom at 5")
        return np.zeros((2,), np.float32)


@pytest.mark.parametrize("thread_pool", [True, False])
def test_a_workers_error_reaches_the_parent(thread_pool):
    loader = data.DataLoader(_Bad(), batch_size=4, num_workers=2,
                             thread_pool=thread_pool)
    with pytest.raises((RuntimeError, ValueError), match="boom at 5"):
        list(loader)


def _segments():
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    except FileNotFoundError:
        return set()


def test_an_abandoned_epoch_unlinks_its_shared_memory():
    x, y = _dataset(64)
    before = _segments()
    loader = data.DataLoader(data.ArrayDataset(x, y), batch_size=8,
                             num_workers=3, prefetch=6, thread_pool=False)
    it = iter(loader)
    first = next(it)
    np.testing.assert_array_equal(first[0].numpy(), x[:8])
    it.close()
    assert _segments() - before == set()
    assert len(list(loader)) == 8            # the loader still works
    assert _segments() - before == set()


@pytest.mark.parametrize("thread_pool", [True, False])
def test_prefetch_zero_with_workers_still_yields(thread_pool):
    x, _ = _dataset(32)
    got = list(data.DataLoader(data.ArrayDataset(x), batch_size=8,
                               num_workers=2, prefetch=0,
                               thread_pool=thread_pool))
    assert len(got) == 4
    np.testing.assert_array_equal(got[0].numpy(), x[:8])


def test_pin_memory_and_a_cuda_tensor_in_a_worker(monkeypatch):
    x, _ = _dataset(16)
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t: pinned.append(t.shape) or t)
    got = list(data.DataLoader(data.ArrayDataset(x), batch_size=8,
                               num_workers=2, thread_pool=False,
                               pin_memory=True))
    assert len(got) == 2 and pinned == [(8, 3, 8, 8)] * 2
    from incubator_mxnet_tpu_torch.gluon.data import dataloader
    fake = torch.zeros(2, device="meta")
    with pytest.raises(TypeError, match="numpy only"):
        dataloader._np_batchify([fake])


def test_spawn_with_an_unpicklable_dataset_takes_threads(monkeypatch):
    import multiprocessing as mp
    real = mp.get_context
    monkeypatch.setattr(mp, "get_all_start_methods", lambda: ["spawn"])
    monkeypatch.setattr(mp, "get_context", lambda m=None: real("spawn"))
    x, _ = _dataset(24)
    scale = 3.0
    ds = data.ArrayDataset(x).transform(lambda img: img * scale)
    loader = data.DataLoader(ds, batch_size=8, num_workers=2,
                             thread_pool=False)
    with pytest.warns(UserWarning, match="falling back to the thread pool"):
        got = list(loader)
    assert len(got) == 3 and loader._spawn_picklable is False
    np.testing.assert_allclose(got[0].numpy(), x[:8] * 3.0, rtol=1e-6)
