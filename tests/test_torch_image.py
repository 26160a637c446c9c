"""The port's image codec, augmenters, iterators and image ops
(``incubator_mxnet_tpu_torch.image`` and ``ops/image_ops.py``) against
the JAX package's, on the CPU, from seeded numpy inputs.

Tolerances:

* Resizes (``jax.image.resize``'s weights, applied by two einsums):
  float32 results within 3e-4 (bilinear) or 1e-3 (cubic, lanczos3) of
  JAX's on [0, 255] values (measured: up to 1.4e-4 and 2.7e-4) — the same weights, summed in another order,
  and XLA contracts some products into FMAs.  A result cast to uint8
  equals JAX's except where the float value lies within that tolerance
  of an integer (the cast truncates), at most 2 % of the values and one
  level apart; the tests count them.  Nearest-neighbour and crops are
  exact.
* ``bilinear_resize_2d``, the box codecs and the remaining ops: 1e-6
  relative, ``bilinear_resize_2d`` 1e-6 of its largest value (the same
  float32 operations; the JAX side runs under ``jit``, where XLA
  contracts products into FMAs, and its ``log``/``exp`` round
  differently in the last place).
* Random augmenters draw from a ``random.Random`` or a
  ``numpy.random.RandomState`` seeded as the JAX package's global
  stream: the draws, crops and label rows are equal.
* The JPEG codec: on the CPU the port decodes with cv2/PIL as the JAX
  package does (equal pixels); ``pack_img``/``unpack_img`` cross both
  ways byte for byte; the colour kernel's plain version equals a
  transcription of libjpeg's fancy upsampling and colour conversion,
  and PIL's decode through its own YCbCr planes.
"""
import io
import random as pyrandom

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu import recordio as jrecordio
from incubator_mxnet_tpu.ops import image_ops as jops
import jax
import jax.numpy as jnp

from incubator_mxnet_tpu_torch import image, recordio
from incubator_mxnet_tpu_torch.ops import image_ops, jpeg_decode

FLOAT_TOL = {"linear": 3e-4, "nearest": 0.0, "cubic": 1e-3,
             "lanczos3": 1e-3}


def _img(rng, h, w, c=3):
    return rng.randint(0, 256, (h, w, c)).astype(np.uint8)


def _hold_uint8(got, want, before, tol, max_share=0.02):
    """uint8 ``got`` equals ``want`` except at near-ties: where the
    float value ``before`` the cast is within ``tol`` of an integer;
    those differ by one level and are at most ``max_share``."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    if not diff.any():
        return 0
    near = np.abs(before - np.round(before)) <= tol
    assert near[diff].all(), "a uint8 mismatch away from a tie"
    assert np.abs(got - want)[diff].max() == 1
    assert diff.mean() <= max_share, diff.mean()
    return int(diff.sum())


# ---- resizes and crops --------------------------------------------------

@pytest.mark.parametrize("size", [(16, 24), (45, 61), (7, 5)])
def test_imresize(size):
    rng = np.random.RandomState(0)
    src = _img(rng, 20, 30)
    w, h = size
    want = jimage.imresize(jmx.nd.array(src, dtype="uint8"), w, h).asnumpy()
    got = image.imresize(torch.tensor(src), w, h).numpy()
    before = image_ops.resize(torch.tensor(src).float(), (h, w, 3)).numpy()
    _hold_uint8(got, want, before, FLOAT_TOL["linear"])
    fsrc = src.astype(np.float32)
    np.testing.assert_allclose(image.imresize(torch.tensor(fsrc), w, h),
                               jimage.imresize(fsrc, w, h).asnumpy(),
                               rtol=0, atol=FLOAT_TOL["linear"])


def test_resize_short_and_crops():
    rng = np.random.RandomState(1)
    for shape in ((20, 30), (31, 17)):
        src = _img(rng, *shape)
        js, ts = jmx.nd.array(src, dtype="uint8"), torch.tensor(src)
        want = jimage.resize_short(js, 12).asnumpy()
        got = image.resize_short(ts, 12).numpy()
        assert got.shape == want.shape
        h, w = got.shape[:2]
        _hold_uint8(got, want, image_ops.resize(ts.float(), (h, w, 3))
                    .numpy(), FLOAT_TOL["linear"])
        for size in ((8, 10), (40, 40)):
            (g, gbox), (j, jbox) = (image.center_crop(ts, size),
                                    jimage.center_crop(js, size))
            assert gbox == jbox
            if size == (8, 10):
                assert np.array_equal(g.numpy(), j.asnumpy())
            pyrandom.seed(3)
            j, jbox = jimage.random_crop(js, size)
            g, gbox = image.random_crop(ts, size, rng=pyrandom.Random(3))
            assert gbox == jbox
            if size == (8, 10):
                assert np.array_equal(g.numpy(), j.asnumpy())
        assert np.array_equal(image.fixed_crop(ts, 2, 3, 5, 4).numpy(),
                              jimage.fixed_crop(js, 2, 3, 5, 4).asnumpy())
    mean, std = [10.0, 20.0, 30.0], [2.0, 3.0, 4.0]
    np.testing.assert_array_equal(
        image.color_normalize(torch.tensor(src), mean, std).numpy(),
        jimage.color_normalize(jmx.nd.array(src, dtype="uint8"), mean,
                               std).asnumpy())


def test_augmenters_draw_alike():
    rng = np.random.RandomState(2)
    src = _img(rng, 24, 32)
    kw = dict(resize=20, rand_crop=True, rand_mirror=True,
              mean=[100, 110, 120], std=[50, 60, 70])
    pyrandom.seed(9)
    jaugs = jimage.CreateAugmenter((3, 16, 16), **kw)
    taugs = image.CreateAugmenter((3, 16, 16), rng=pyrandom.Random(9), **kw)
    assert [type(a).__name__ for a in jaugs] == \
        [type(a).__name__ for a in taugs]
    j, t = jmx.nd.array(src, dtype="uint8"), torch.tensor(src)
    for _ in range(4):
        jo, to = j, t
        for ja, ta in zip(jaugs, taugs):
            jo, to = ja(jo), ta(to)
        np.testing.assert_allclose(to.numpy(), jo.asnumpy(), rtol=0,
                                   atol=1 / 50 + 1e-5)
        assert (np.abs(to.numpy() - jo.asnumpy()) > 1e-5).mean() <= 0.02
    with pytest.raises(NotImplementedError, match="brightness"):
        image.CreateAugmenter((3, 16, 16), brightness=0.1)


# ---- ImageIter ------------------------------------------------------------

def _jpeg_rec(tmp_path, n=7, seed=4):
    rng = np.random.RandomState(seed)
    path = str(tmp_path / "img.rec")
    w = jrecordio.MXRecordIO(path, "w")
    for i in range(n):
        img = _img(rng, 18 + i, 22)
        w.write(jrecordio.pack_img(jrecordio.IRHeader(0, float(i), i, 0), img,
                                   quality=95))
    w.close()
    return path


def test_image_iter_against_jax(tmp_path):
    path = _jpeg_rec(tmp_path, n=6)
    pyrandom.seed(5)
    j = jimage.ImageIter(2, (3, 16, 16), path_imgrec=path, shuffle=True,
                         label_width=1)
    t = image.ImageIter(2, (3, 16, 16), path_imgrec=path, shuffle=True,
                        device="cpu", rng=pyrandom.Random(5))
    n = 0
    for jb, tb in zip(j, t):
        assert np.array_equal(tb.data[0].numpy(), jb.data[0].asnumpy())
        assert np.array_equal(tb.label[0].numpy(), jb.label[0].asnumpy())
        n += 1
    assert n == 3
    with pytest.raises(StopIteration):
        next(t)
    t.reset()
    assert next(t).data[0].shape == (2, 3, 16, 16)
    with pytest.raises(TypeError, match="unknown"):
        image.ImageIter(2, (3, 16, 16), path_imgrec=path, device="cpu",
                        bogus=1)


def test_image_iter_cannot_decode_raw_records(tmp_path):
    """As the JAX ImageIter (image.py:260-261): a raw record fails to
    decode; ImageRecordIter reads them."""
    rng = np.random.RandomState(6)
    path = str(tmp_path / "raw.rec")
    w = recordio.MXRecordIO(path, "w")
    for i in range(2):
        w.write(recordio.pack_raw(recordio.IRHeader(0, float(i), i, 0),
                                  _img(rng, 16, 16)))
    w.close()
    with pytest.raises(ValueError):
        next(jimage.ImageIter(2, (3, 16, 16), path_imgrec=path))
    with pytest.raises(ValueError):
        next(image.ImageIter(2, (3, 16, 16), path_imgrec=path, device="cpu"))


# ---- detection --------------------------------------------------------------

def _det_items(rng, n=5):
    items = []
    for _ in range(n):
        img = _img(rng, 30, 40)
        k = rng.randint(1, 4)
        boxes = []
        for _ in range(k):
            x0, y0 = rng.uniform(0, 0.6, 2)
            boxes.append([rng.randint(0, 5), x0, y0,
                          x0 + rng.uniform(0.2, 0.4),
                          y0 + rng.uniform(0.2, 0.4)])
        items.append((img, np.asarray(boxes, np.float32)))
    return items


def test_det_augmenters_and_iter():
    rng = np.random.RandomState(7)
    items = [(img.astype(np.float32), lab) for img, lab in _det_items(rng)]
    kw = dict(rand_crop=1, rand_mirror=True, rand_pad=1)
    for mean in (None, [120.0, 110.0, 100.0]):
        np.random.seed(13)
        jit = jimage.ImageDetIter(
            2, (3, 20, 24), items,
            jimage.CreateDetAugmenter((3, 20, 24), mean=mean, **kw),
            shuffle=True, label_shape=(4, 5))
        r = np.random.RandomState(13)
        tit = image.ImageDetIter(
            2, (3, 20, 24), items,
            image.CreateDetAugmenter((3, 20, 24), mean=mean, rng=r, **kw),
            shuffle=True, label_shape=(4, 5), device="cpu", rng=r)
        n = 0
        for jb, tb in zip(jit, tit):
            assert tb.pad == jb.pad
            assert np.array_equal(tb.label[0].numpy(), jb.label[0].asnumpy())
            np.testing.assert_allclose(tb.data[0].numpy(),
                                       jb.data[0].asnumpy(), rtol=0,
                                       atol=FLOAT_TOL["linear"])
            n += 1
        assert n == 3
        labels = tb.label[0].numpy()
        assert ((labels == -1).all(-1) | (labels[..., 0] >= 0)).all()


def test_det_border_and_flip():
    rng = np.random.RandomState(8)
    img, lab = _det_items(rng, 1)[0]
    jo, jl = jimage.DetBorderAug()(img, lab)
    to, tl = image.DetBorderAug()(torch.tensor(img), lab)
    assert np.array_equal(to.numpy(), jo) and np.array_equal(tl, jl)
    np.random.seed(1)
    jo, jl = jimage.DetHorizontalFlipAug(1.0)(img, lab)
    to, tl = image.DetHorizontalFlipAug(1.0, np.random.RandomState(1))(
        torch.tensor(img), lab)
    assert np.array_equal(to.numpy(), jo) and np.array_equal(tl, jl)


# ---- the codec ------------------------------------------------------------

def test_pack_img_unpack_img_cross():
    rng = np.random.RandomState(9)
    img = _img(rng, 21, 13)
    hdr = recordio.IRHeader(0, 3.0, 7, 0)
    ours = recordio.pack_img(hdr, torch.tensor(img), quality=90)
    theirs = jrecordio.pack_img(jrecordio.IRHeader(0, 3.0, 7, 0), img,
                                quality=90)
    assert ours == theirs
    h, got = recordio.unpack_img(theirs, device="cpu")
    _, want = jrecordio.unpack_img(ours)
    assert h.label == 3.0 and np.array_equal(got.numpy(), want)
    assert np.array_equal(image.imdecode(theirs[24:], device="cpu").numpy(),
                          jimage.imdecode(theirs[24:]).asnumpy())
    with pytest.raises(NotImplementedError, match="nvJPEG"):
        image.imencode(torch.empty(2, 2, 3, dtype=torch.uint8,
                                   device="meta"))


def test_jpeg_parsing_and_refusals():
    rng = np.random.RandomState(10)
    for h, w in ((21, 13), (1, 300)):
        buf = image.imencode(_img(rng, h, w))
        assert jpeg_decode.jpeg_size(buf) == (h, w, 3)
        jpeg_decode.check_jpeg(buf)
        with pytest.raises(ValueError, match="truncated"):
            jpeg_decode.check_jpeg(buf[:len(buf) // 2])
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(_img(rng, 9, 11, 1)[..., 0]).save(bio, format="JPEG")
    assert jpeg_decode.jpeg_size(bio.getvalue()) == (9, 11, 1)
    png = image.imencode(_img(rng, 4, 4), fmt=".png")
    with pytest.raises(ValueError, match="PNG"):
        jpeg_decode.check_jpeg(png)


def _fancy(p, h, w, mode):
    """libjpeg-turbo's jdsample.c loops, transcribed: h2v1 (mode 1),
    h2v2 (2), h1v2 (3) fancy upsampling of one coded plane."""
    p = p.astype(np.int64)
    ch, cw = p.shape
    if mode == 3:
        out = np.zeros((2 * ch, cw), np.int64)
        for r in range(ch):
            for v in range(2):
                r1 = p[max(r - 1, 0)] if v == 0 else p[min(r + 1, ch - 1)]
                out[2 * r + v] = (p[r] * 3 + r1 + (1 if v == 0 else 2)) >> 2
        return out[:h, :w]
    rows = [(r, v) for r in range(ch) for v in range(2)] if mode == 2 \
        else [(r, None) for r in range(h)]
    out = np.zeros((len(rows), 2 * cw), np.int64)
    for i, (r, v) in enumerate(rows):
        if mode == 1:
            inp = p[r]
            o = out[i]
            o[0] = inp[0]
            o[1] = (inp[0] * 3 + inp[1] + 2) >> 2
            for c in range(1, cw - 1):
                o[2 * c] = (inp[c] * 3 + inp[c - 1] + 1) >> 2
                o[2 * c + 1] = (inp[c] * 3 + inp[c + 1] + 2) >> 2
            o[2 * cw - 2] = (inp[cw - 1] * 3 + inp[cw - 2] + 1) >> 2
            o[2 * cw - 1] = inp[cw - 1]
            continue
        in0 = p[r]
        in1 = p[max(r - 1, 0)] if v == 0 else p[min(r + 1, ch - 1)]
        o = out[i]
        this, nxt = in0[0] * 3 + in1[0], in0[1] * 3 + in1[1]
        o[0] = (this * 4 + 8) >> 4
        o[1] = (this * 3 + nxt + 7) >> 4
        last, this, k = this, nxt, 2
        for c in range(2, cw):
            nxt = in0[c] * 3 + in1[c]
            o[k] = (this * 3 + last + 8) >> 4
            o[k + 1] = (this * 3 + nxt + 7) >> 4
            last, this, k = this, nxt, k + 2
        o[k] = (this * 3 + last + 8) >> 4
        o[k + 1] = (this * 4 + 7) >> 4
    return out[:h, :w]


def _ycc_rgb_numpy(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert with build_ycc_rgb_table's tables."""
    x = np.arange(256) - 128
    cr_r = (91881 * x + 32768) >> 16
    cb_b = (116130 * x + 32768) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + 32768
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_ycc_rgb_reference_is_libjpeg(mode):
    rng = np.random.RandomState(11 + mode)
    for h, w in ((5, 7), (6, 8), (9, 3)):
        ch = (h + 1) // 2 if mode in (2, 3) else h
        cw = (w + 1) // 2 if mode in (1, 2) else w
        y = rng.randint(0, 256, (h, w)).astype(np.uint8)
        if mode == 4:
            got = jpeg_decode.ycc_rgb(torch.tensor(y), None, None, 4)
            assert np.array_equal(got.numpy(), np.repeat(y[..., None], 3, -1))
            continue
        cb = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
        cr = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
        up = (lambda p: p) if mode == 0 else \
            (lambda p: _fancy(p, h, w, mode))
        want = _ycc_rgb_numpy(y, up(cb), up(cr))
        got = jpeg_decode.ycc_rgb(torch.tensor(y), torch.tensor(cb),
                                  torch.tensor(cr), mode)
        assert np.array_equal(got.numpy(), want)


def test_ycc_rgb_reference_matches_pil_decode():
    from PIL import Image
    rng = np.random.RandomState(12)
    img = np.clip(np.cumsum(rng.randint(-9, 10, (30, 40, 3)), 1) + 128, 0,
                  255).astype(np.uint8)
    for sub in (0, 2):
        bio = io.BytesIO()
        Image.fromarray(img).save(bio, format="JPEG", quality=85,
                                  subsampling=sub)
        im = Image.open(io.BytesIO(bio.getvalue()))
        im.draft("YCbCr", im.size)      # libjpeg's planes, upsampled
        ycc = np.asarray(im)
        got = jpeg_decode.ycc_rgb_reference(
            *(torch.tensor(np.ascontiguousarray(ycc[..., k]))
              for k in range(3)), 0)
        rgb = np.asarray(Image.open(io.BytesIO(bio.getvalue()))
                         .convert("RGB"))
        assert np.array_equal(got.numpy(), rgb)


# ---- ops/image_ops -----------------------------------------------------------

@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_image_resize_interp(interp):
    rng = np.random.RandomState(20 + interp)
    method = image_ops._INTERP[interp][0]
    tol = FLOAT_TOL[method]
    for src, size, keep in ((_img(rng, 20, 30), (12, 9), False),
                            (_img(rng, 2, 9, 14), 11, True),
                            (_img(rng, 17, 13), 25, False)):
        src = src if src.ndim == 3 or src.shape[-1] != 14 else \
            src.reshape(2, 9, 14, 1)
        want = np.asarray(jops.image_resize.fn(jnp.asarray(src), size=size,
                                               keep_ratio=keep,
                                               interp=interp))
        got = image_ops.image_resize(torch.tensor(src), size=size,
                                     keep_ratio=keep, interp=interp).numpy()
        assert got.shape == want.shape
        fwant = np.asarray(jops.image_resize.fn(
            jnp.asarray(src.astype(np.float32)), size=size, keep_ratio=keep,
            interp=interp))
        fgot = image_ops.image_resize(torch.tensor(src.astype(np.float32)),
                                      size=size, keep_ratio=keep,
                                      interp=interp).numpy()
        np.testing.assert_allclose(fgot, fwant, rtol=0, atol=tol)
        _hold_uint8(got, want, fgot, tol)


def test_cast_like_xla_saturates():
    x = np.array([-300., -3.7, -0.5, 0.3, 254.9, 255.99, 256., 300., 1000.],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.uint8))
    got = image_ops.cast_like_xla(torch.tensor(x), torch.uint8).numpy()
    assert np.array_equal(got, want)


def test_image_simple_ops():
    rng = np.random.RandomState(30)
    x = _img(rng, 2, 9, 7)[..., :3].reshape(2, 9, 7, 3) if False else \
        rng.randint(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    for arr in (x, x[0]):
        t, j = torch.tensor(arr), jnp.asarray(arr)
        assert np.array_equal(image_ops.image_crop(t, 1, 2, 3, 4).numpy(),
                              np.asarray(jops.image_crop.fn(j, 1, 2, 3, 4)))
        tt = image_ops.image_to_tensor(t)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(
            jops.image_to_tensor.fn(j)))
        mean, std = (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)
        np.testing.assert_allclose(
            image_ops.image_normalize(tt, mean, std).numpy(),
            np.asarray(jops.image_normalize.fn(jnp.asarray(tt.numpy()),
                                               mean, std)), rtol=1e-6)
        out = image_ops.image_random_crop(
            t, 4, 5, generator=torch.Generator().manual_seed(0)).numpy()
        assert out.shape[-3:-1] == (5, 4)
        H, W = arr.shape[-3], arr.shape[-2]
        assert any(np.array_equal(out, arr[..., y:y + 5, x0:x0 + 4, :])
                   for y in range(H - 4) for x0 in range(W - 3))
    for seed in (0, 1, 2):
        src = _img(rng, 30, 25)
        want = np.asarray(jops.image_random_resized_crop.fn(
            src, size=(12, 10), seed=seed))
        got = image_ops.image_random_resized_crop(
            torch.tensor(src), size=(12, 10), seed=seed).numpy()
        assert got.shape == want.shape == (10, 12, 3)
        assert np.abs(got.astype(int) - want).max() <= 1
        assert (got != want).mean() <= 0.02


_BILINEAR = [dict(mode="size", height=7, width=11),
             dict(mode="size", scale_height=1.5, scale_width=0.5),
             dict(mode="odd_scale", scale_height=2.0, scale_width=0.75),
             dict(mode="like"),
             dict(mode="to_even_down"), dict(mode="to_even_up"),
             dict(mode="to_odd_down"), dict(mode="to_odd_up")]


@pytest.mark.parametrize("kw", _BILINEAR)
def test_bilinear_resize_2d(kw):
    rng = np.random.RandomState(40)
    x = rng.randn(2, 3, 9, 6).astype(np.float32)
    like = np.zeros((1, 1, 4, 13), np.float32)
    for ac in (True, False):
        args = dict(kw, align_corners=ac)
        if kw["mode"] == "like":
            args["like"] = like
        static = {k: v for k, v in args.items() if k != "like"}
        fn = jax.jit(lambda a, lk: jops.bilinear_resize_2d.fn(
            a, like=lk, **static))
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(like)))
        if "like" in args:
            args["like"] = torch.tensor(like)
        got = image_ops.bilinear_resize_2d(torch.tensor(x), **args).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_box_codecs_and_small_ops():
    rng = np.random.RandomState(50)
    anchors = np.sort(rng.rand(2, 6, 4).astype(np.float32), -1)[..., [0, 1, 2, 3]]
    anchors = np.concatenate([anchors[..., :2], anchors[..., :2]
                              + rng.uniform(0.1, 0.5, (2, 6, 2))], -1) \
        .astype(np.float32)
    refs = np.concatenate([anchors[:, :3, :2] + 0.05,
                           anchors[:, :3, :2] + 0.3], -1).astype(np.float32)
    samples = (rng.rand(2, 6) > 0.4).astype(np.float32)
    matches = rng.randint(-1, 3, (2, 6)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(jops.box_encode.fn)(
        jnp.asarray(samples), jnp.asarray(matches), jnp.asarray(anchors),
        jnp.asarray(refs))]
    got = image_ops.box_encode(torch.tensor(samples), torch.tensor(matches),
                               torch.tensor(anchors), torch.tensor(refs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    deltas = rng.randn(2, 6, 4).astype(np.float32)
    for fmt, clip in (("corner", -1.0), ("center", 0.3)):
        w = np.asarray(jax.jit(lambda d, a: jops.box_decode.fn(
            d, a, clip=clip, format=fmt))(jnp.asarray(deltas),
                                          jnp.asarray(anchors)))
        g = image_ops.box_decode(torch.tensor(deltas), torch.tensor(anchors),
                                 clip=clip, format=fmt).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    a = rng.randn(3, 4).astype(np.float32)
    assert float(image_ops.allclose(torch.tensor(a), torch.tensor(a))) == \
        float(jops.allclose.fn(jnp.asarray(a), jnp.asarray(a))) == 1.0
    assert float(image_ops.allclose(torch.tensor(a), torch.tensor(a + 1))) \
        == 0.0
    for kw in (dict(), dict(start=2.0, step=0.5, repeat=2),
               dict(axis=1, start=1.0)):
        np.testing.assert_array_equal(
            image_ops.arange_like(torch.tensor(a), **kw).numpy(),
            np.asarray(jops.arange_like.fn(jnp.asarray(a), **kw)))
    np.testing.assert_allclose(
        image_ops.quadratic(torch.tensor(a), 0.5, -1.0, 2.0).numpy(),
        np.asarray(jops.quadratic.fn(jnp.asarray(a), 0.5, -1.0, 2.0)),
        rtol=1e-6)
    q = rng.randn(5, 2, 3 * 4).astype(np.float32)
    kv = rng.randn(7, 2, 3 * 2 * 4).astype(np.float32)
    att = np.asarray(jops.interleaved_matmul_encdec_qk.fn(
        jnp.asarray(q), jnp.asarray(kv), heads=3))
    np.testing.assert_allclose(image_ops.interleaved_matmul_encdec_qk(
        torch.tensor(q), torch.tensor(kv), heads=3).numpy(), att,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(image_ops.interleaved_matmul_encdec_valatt(
        torch.tensor(kv), torch.tensor(att), heads=3).numpy(),
        np.asarray(jops.interleaved_matmul_encdec_valatt.fn(
            jnp.asarray(kv), jnp.asarray(att), heads=3)),
        rtol=1e-5, atol=1e-5)
