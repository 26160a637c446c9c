"""The port's data iterators (``incubator_mxnet_tpu_torch.io``) and the
batch kernel's plain version, against the JAX package on the CPU.

* ``ImageRecordIter`` with ``device="cpu"`` (the ``image_batch``
  kernel's plain version) against the JAX ``NativeImageRecordIter``
  (``src/image_iter.cc``) over raw ``b"MXTR"`` records with no
  randomness, bit for bit: resize, mean/std/scale, one channel,
  ``label_width`` 2 with label arrays, ``round_batch`` wrap and its
  ``pad``, and the short last batch without it; prefetch 0 and 4 alike.
  Over small JPEG records the port decodes with cv2 (or PIL) and the
  native iterator with libjpeg: measured here, the decoded pixels are
  the same (tolerance 0), so the batches are compared bit for bit too.
* Shuffle, random crops and mirrors are held by their properties: each
  epoch a permutation, epochs differ, the same seed repeats.
* ``image_batch_reference`` against a numpy float32 transcription of
  the native ``ResizeBilinear`` and normalisation, bit for bit.
* ``NDArrayIter`` (pad, discard, shuffle from a RandomState seeded as
  the JAX package's global one), ``ResizeIter``, ``PrefetchingIter``,
  ``CSVIter``, ``LibSVMIter`` (dense rows against the JAX CSR batch)
  and ``MNISTIter`` (the synthetic set), batch for batch, exactly.
"""
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import recordio
from incubator_mxnet_tpu_torch.ops import image_batch as ib


def _raw_rec(path, n=13, seed=0, sizes=(5, 40)):
    """n raw records of random sizes; odd ones carry a 2-value label."""
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        h, ww = rng.randint(*sizes, 2)
        img = rng.randint(0, 256, (h, ww, 3)).astype(np.uint8)
        lab = [float(i), 2.0 * i + 0.5] if i % 2 else float(i)
        w.write(recordio.pack_raw(recordio.IRHeader(0, lab, i, 0), img))
    w.close()
    return path


def _jpeg_rec(path, n=10, seed=1):
    import cv2
    from PIL import Image
    import io
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        h, ww = rng.randint(9, 50, 2)
        arr = cv2.GaussianBlur((rng.rand(h, ww, 3) * 255).astype(np.uint8),
                               (5, 5), 0)
        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, format="JPEG", quality=90,
                                  subsampling=2 * (i % 2))
        w.write(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                              bio.getvalue()))
    w.close()
    return path


def _batches(it, native):
    out = []
    for b in it:
        if native:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        else:
            out.append((b.data[0].numpy(), b.label[0].numpy(), b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert da.shape == db.shape and da.dtype == db.dtype == np.float32
        assert np.array_equal(da.view(np.uint32), db.view(np.uint32))
        assert np.array_equal(la, lb)
        assert pa == pb


_OPTIONS = [
    dict(data_shape=(3, 16, 16)),
    dict(data_shape=(3, 8, 8), resize=12),
    dict(data_shape=(3, 8, 8), resize=20, batch_size=5),
    dict(data_shape=(1, 16, 16), mean_r=10.0, std_r=3.0, scale=0.5),
    dict(data_shape=(3, 16, 16), mean_r=123.68, mean_g=116.28,
         mean_b=103.53, std_r=58.395, std_g=57.12, std_b=57.375,
         scale=1 / 255, label_width=2),
    dict(data_shape=(3, 8, 8), round_batch=False, label_width=2),
    dict(data_shape=(1, 8, 8), resize=9, std_r=-1.0, scale=0.0),
]


@pytest.mark.parametrize("opts", _OPTIONS)
def test_image_record_iter_raw_matches_native(tmp_path, opts):
    path = _raw_rec(str(tmp_path / "raw.rec"))
    kw = dict(dict(batch_size=4), **opts)
    want = _batches(jmx.io.NativeImageRecordIter(path, **kw), True)
    got = _batches(tio.ImageRecordIter(path, device="cpu", **kw), False)
    _same(got, want)
    sync = _batches(tio.ImageRecordIter(path, device="cpu",
                                        prefetch_buffer=0, **kw), False)
    _same(sync, want)


def test_image_record_iter_pads(tmp_path):
    path = _raw_rec(str(tmp_path / "raw.rec"), n=10)
    for rb, pads in ((True, [0, 0, 2]), (False, [0, 0, 2])):
        it = tio.ImageRecordIter(path, data_shape=(3, 8, 8), batch_size=4,
                                 round_batch=rb, device="cpu")
        got = [b.pad for b in it]
        assert got == pads
    it = tio.ImageRecordIter(path, data_shape=(3, 8, 8), batch_size=4,
                             round_batch=False, device="cpu")
    last = list(it)[-1]
    assert not last.data[0][2:].any() and not last.label[0][2:].any()
    assert it.num_samples == 10
    assert it.provide_data[0].shape == (4, 3, 8, 8)
    assert it.provide_label[0].shape == (4,)


def test_image_record_iter_jpeg_matches_native(tmp_path):
    path = _jpeg_rec(str(tmp_path / "jpeg.rec"))
    for kw in (dict(data_shape=(3, 16, 16), resize=20),
               dict(data_shape=(1, 8, 8), mean_r=100.0, std_r=50.0)):
        kw["batch_size"] = 3
        want = _batches(jmx.io.NativeImageRecordIter(path, **kw), True)
        got = _batches(tio.ImageRecordIter(path, device="cpu",
                                           preprocess_threads=2, **kw), False)
        _same(got, want)


def test_image_record_iter_shuffle_and_draws(tmp_path):
    path = _raw_rec(str(tmp_path / "raw.rec"), n=20, sizes=(20, 40))
    kw = dict(data_shape=(3, 16, 16), batch_size=20, shuffle=True,
              rand_crop=True, rand_mirror=True, device="cpu")

    def epochs(seed, prefetch=4):
        it = tio.ImageRecordIter(path, seed=seed, prefetch_buffer=prefetch,
                                 **kw)
        out = []
        for _ in range(3):
            (b,) = list(it)
            out.append((b.label[0].numpy().copy(), b.data[0].numpy().copy()))
            it.reset()
        return out

    a, again, sync, other = epochs(7), epochs(7), epochs(7, 0), epochs(8)
    for (la, da), (lb, db), (ls, ds) in zip(a, again, sync):
        assert sorted(la.tolist()) == list(range(20))   # a permutation
        assert np.array_equal(la, lb) and np.array_equal(da, db)
        assert np.array_equal(la, ls) and np.array_equal(da, ds)
    assert not np.array_equal(a[0][0], a[1][0])         # epochs differ
    assert not np.array_equal(a[0][0], other[0][0])     # seeds differ
    # crops and mirrors: every image is some crop of its resized record
    plain = tio.ImageRecordIter(path, data_shape=(3, 16, 16), batch_size=20,
                                device="cpu")
    (b,) = list(plain)
    assert not np.array_equal(b.data[0].numpy(), a[0][1])


def test_image_record_iter_refuses(tmp_path):
    path = _raw_rec(str(tmp_path / "raw.rec"), n=3)
    with pytest.raises(TypeError, match="rand_resize"):
        tio.ImageRecordIter(path, data_shape=(3, 8, 8), rand_resize=True,
                            device="cpu")
    with pytest.raises(ValueError, match="channels"):
        tio.ImageRecordIter(path, data_shape=(2, 8, 8), device="cpu")
    bad = str(tmp_path / "bad.rec")
    w = recordio.MXRecordIO(bad, "w")
    w.write(recordio.pack(recordio.IRHeader(0, 1.0, 0, 0),
                          b"MXTR" + np.array([4, 4], np.int32).tobytes()))
    w.close()
    it = tio.ImageRecordIter(bad, data_shape=(3, 8, 8), batch_size=1,
                             device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        next(it)


# ---- the batch kernel's plain version against a numpy transcription ----

def _native_numpy(img, rh, rw, y0, x0, mirror, c, H, W, mean, std, scale):
    """``ResizeBilinear`` + crop + normalize of src/image_iter.cc, in
    numpy float32 scalars, loop for loop."""
    f32 = np.float32
    h, w = img.shape[:2]
    ys = f32(h - 1) / f32(rh - 1) if rh > 1 else f32(0)
    xs = f32(w - 1) / f32(rw - 1) if rw > 1 else f32(0)
    out = np.zeros((c, H, W), np.float32)
    for y in range(H):
        fy = f32(y0 + y) * ys
        iy0 = int(fy)
        iy1 = min(iy0 + 1, h - 1)
        wy = fy - f32(iy0)
        for x in range(W):
            rx = x0 + (W - 1 - x if mirror else x)
            fx = f32(rx) * xs
            ix0 = int(fx)
            ix1 = min(ix0 + 1, w - 1)
            wx = fx - f32(ix0)
            px = []
            for ch in range(3):
                v = (f32(img[iy0, ix0, ch]) * (f32(1) - wy) * (f32(1) - wx)
                     + f32(img[iy0, ix1, ch]) * (f32(1) - wy) * wx
                     + f32(img[iy1, ix0, ch]) * wy * (f32(1) - wx)
                     + f32(img[iy1, ix1, ch]) * wy * wx)
                px.append(f32(int(v + f32(0.5))))
            if c == 3:
                for ch in range(3):
                    out[ch, y, x] = (px[ch] - f32(mean[ch])) * f32(scale) \
                        / f32(std[ch])
            else:
                grey = f32(0.299) * px[0] + f32(0.587) * px[1] \
                    + f32(0.114) * px[2]
                out[0, y, x] = (grey - f32(mean[0])) * f32(scale) \
                    / f32(std[0])
    return out


@pytest.mark.parametrize("channels", [3, 1])
def test_image_batch_reference_matches_native_transcription(channels):
    rng = np.random.RandomState(5)
    H, W, resize = 7, 9, 10
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((12, 20), (7, 9), (3, 4), (30, 11), (1, 1))]
    rows, off = [], 0
    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        rh, rw = ib.resized_size(h, w, H, W, resize if i % 2 else 0)
        y0 = rng.randint(0, rh - H + 1)
        x0 = rng.randint(0, rw - W + 1)
        rows.append(ib.sample_row(off, h, w, rh, rw, y0, x0, i % 3 == 0))
        off += img.size
    rows.append([0] * 8)                          # an empty slot
    mean, std, scale = (11.5, 120.25, 3.0), (3.5, 0.7, 60.0), 0.37
    src = torch.from_numpy(np.concatenate([i.reshape(-1) for i in imgs]))
    got = ib.image_batch_reference(src, torch.tensor(rows),
                                   (len(rows), channels, H, W), mean, std,
                                   scale).numpy()
    for b, img in enumerate(imgs):
        _, h, w, rh, rw, y0, x0, mirror = rows[b]
        want = _native_numpy(img, rh, rw, y0, x0, mirror, channels, H, W,
                             mean, std, scale)
        assert np.array_equal(got[b].view(np.uint32), want.view(np.uint32))
    assert not got[-1].any()


def test_image_batch_passthrough_and_sizes():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    table = torch.tensor([ib.sample_row(0, 6, 5, 6, 5, 0, 0, 0)])
    got = ib.image_batch(torch.from_numpy(img.reshape(-1)), table,
                         (1, 3, 6, 5)).numpy()[0]
    assert np.array_equal(got, img.transpose(2, 0, 1).astype(np.float32))
    assert ib.resized_size(375, 500, 224, 224, 256) == (256, 341)
    assert ib.resized_size(500, 333, 224, 224, 256) == (384, 256)
    assert ib.resized_size(10, 20, 224, 224, 256) == (256, 512)
    assert ib.resized_size(10, 20, 16, 24, 0) == (16, 24)
    assert ib.resized_size(100, 30, 50, 40, 20) == (67, 40)


def test_image_batch_refuses_cuda_shapes():
    with pytest.raises(ValueError, match="unsupported device"):
        ib._check(torch.zeros(3, dtype=torch.uint8), torch.zeros(1, 8,
                  dtype=torch.int64), (1, 3, 1, 1))


# ---- the other iterators ------------------------------------------------

def _np_batches(it, native):
    out = []
    for b in it:
        get = (lambda a: a.asnumpy()) if native else (lambda a: a.numpy())
        out.append(([get(d) for d in b.data], [get(lb) for lb in b.label],
                    b.pad))
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("handle,shuffle", [("pad", False),
                                            ("discard", False),
                                            ("pad", True)])
def test_ndarray_iter(handle, shuffle):
    rng = np.random.RandomState(0)
    data = rng.rand(10, 3).astype(np.float64)
    label = rng.randint(0, 4, 10).astype(np.int32)
    np.random.seed(11)
    j = jmx.io.NDArrayIter(data, label, 4, shuffle=shuffle,
                           last_batch_handle=handle)
    want = _np_batches(j, True)
    j.reset()
    want += _np_batches(j, True)
    t = tio.NDArrayIter(data, label, 4, shuffle=shuffle,
                        last_batch_handle=handle, device="cpu",
                        rng=np.random.RandomState(11))
    got = _np_batches(t, False)
    t.reset()
    got += _np_batches(t, False)
    _same_batches(got, want)
    assert [d.shape for d in t.provide_data] == \
        [d.shape for d in j.provide_data]
    assert t.provide_label[0].dtype == j.provide_label[0].dtype


def test_resize_and_prefetching_iter():
    data = np.arange(30, dtype=np.float32).reshape(10, 3)

    def pair():
        return (jmx.io.NDArrayIter(data, None, 3),
                tio.NDArrayIter(data, None, 3, device="cpu"))

    j, t = pair()
    _same_batches(_np_batches(tio.ResizeIter(t, 7), False),
                  _np_batches(jmx.io.ResizeIter(j, 7), True))
    j, t = pair()
    jp, tp = jmx.io.PrefetchingIter(j), tio.PrefetchingIter(t)
    _same_batches(_np_batches(tp, False), _np_batches(jp, True))
    tp.reset()
    assert len(_np_batches(tp, False)) == 4
    assert tp.provide_data[0].shape == (3, 3)


def test_csv_iter(tmp_path):
    rng = np.random.RandomState(2)
    d, lab = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(d, rng.rand(7, 6), delimiter=",")
    np.savetxt(lab, rng.randint(0, 3, (7, 1)), delimiter=",")
    for kw in (dict(label_csv=lab), dict(round_batch=False), {}):
        want = _np_batches(jmx.io.CSVIter(d, (2, 3), batch_size=3, **kw),
                           True)
        got = _np_batches(tio.CSVIter(d, (2, 3), batch_size=3, device="cpu",
                                      **kw), False)
        _same_batches(got, want)
    with pytest.raises(TypeError):
        tio.CSVIter(d, (2, 3), batch_size=3, device="cpu", dtype="int8")


def test_libsvm_iter_dense(tmp_path):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:2\n0 1:-1\n\n2 2:0.25 4:7 0:1\n1\n3 4:1\n")
    for rb in (True, False):
        j = jmx.io.LibSVMIter(path, (5,), 2, round_batch=rb)
        t = tio.LibSVMIter(path, (5,), 2, round_batch=rb, device="cpu")
        want, got = _np_batches(j, True), _np_batches(t, False)
        _same_batches(got, want)
    with pytest.raises(NotImplementedError, match="item 12"):
        tio.LibSVMIter(path, (5,), 2, label_libsvm=path, device="cpu")


def test_mnist_iter():
    np.random.seed(4)
    j = jmx.io.MNISTIter(batch_size=100, shuffle=True, flat=True)
    t = tio.MNISTIter(batch_size=100, shuffle=True, flat=True, device="cpu",
                      rng=np.random.RandomState(4))
    _same_batches(_np_batches(t, False), _np_batches(j, True))
    t2 = tio.MNISTIter(image="t10k-images-idx3-ubyte", batch_size=64,
                       shuffle=False, device="cpu")
    b = next(iter(t2))
    assert b.data[0].shape == (64, 1, 28, 28) and b.data[0].max() <= 1.0


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _raw_rec(str(tmp_path / "raw.rec"), n=3)
    with pytest.raises(DeviceUnavailableError):
        tio.ImageRecordIter(path, data_shape=(3, 8, 8))
    with pytest.raises(DeviceUnavailableError):
        tio.NDArrayIter(np.zeros((2, 2), np.float32))
