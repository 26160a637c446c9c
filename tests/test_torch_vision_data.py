"""The port's ``gluon.data.vision`` (transforms and datasets) against the
JAX package's, on the CPU, from seeded numpy inputs.

The random transforms draw from a ``numpy.random.RandomState`` (or, for
``RandomCrop``, a ``random.Random``) seeded as the JAX package's global
stream, so the draws are the same call for call.  Tolerances: exact
where the op is (crops, flips, casts, ``ToTensor``); float32 results of
the resizes within 3e-4 on [0, 255] values (the same weights, summed in
another order; XLA contracts products into FMAs); the colour transforms
on float32 images within 2e-4 (their luminance dot products and means
are summed in another order); on uint8 images, values equal but for
one level at near-ties of the truncating cast (at most 2 %);
``Rotate`` within 1e-4.  The datasets' synthetic sets and files read
from disk are equal.
"""
import gzip
import os
import random as pyrandom
import struct

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.data.vision import datasets as jds
from incubator_mxnet_tpu.gluon.data.vision import transforms as jt

from incubator_mxnet_tpu_torch.gluon import data
from incubator_mxnet_tpu_torch.gluon.data.vision import datasets as tds
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as tt

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_jpeg")


def _u8(rng, *shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


def _run(jblock, tblock, x, seed=None, py=False):
    """Both transforms on ``x`` from the same stream → numpy pair."""
    if seed is not None:
        (pyrandom if py else np.random).seed(seed)
    j = jblock(jmx.nd.array(x, dtype=str(x.dtype))).asnumpy()
    t = tblock(torch.tensor(x)).numpy()
    return t, j


def _near_ties(got, want, share=0.02):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


def test_exact_transforms():
    rng = np.random.RandomState(0)
    x = _u8(rng, 10, 12, 3)
    for jb, tb in ((jt.Cast("float32"), tt.Cast("float32")),
                   (jt.ToTensor(), tt.ToTensor()),
                   (jt.CenterCrop((5, 7)), tt.CenterCrop((5, 7))),
                   (jt.CenterCrop(20), tt.CenterCrop(20)),
                   (jt.CropResize(1, 2, 6, 5), tt.CropResize(1, 2, 6, 5))):
        got, want = _run(jb, tb, x)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    batch = _u8(rng, 2, 10, 12, 3)
    got, want = _run(jt.ToTensor(), tt.ToTensor(), batch)
    assert np.array_equal(got, want)
    f = rng.rand(3, 4, 5).astype(np.float32)
    got, want = _run(jt.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.1)),
                     tt.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.1)), f)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(20, 30, 3), (2, 9, 14, 3)])
def test_resize(shape):
    rng = np.random.RandomState(1)
    x = _u8(rng, *shape)
    got, want = _run(jt.Resize((11, 7)), tt.Resize((11, 7)), x)
    assert got.shape == want.shape
    _near_ties(got, want)
    got, want = _run(jt.Resize(13), tt.Resize(13), x.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    with pytest.raises(NotImplementedError):
        tt.Resize(8, keep_ratio=True)


def test_random_resized_crop_and_compose():
    rng = np.random.RandomState(2)
    x = _u8(rng, 40, 30, 3).astype(np.float32)
    for kw in (dict(), dict(scale=(2.0, 3.0))):       # the second falls back
        for seed in range(3):
            got, want = _run(jt.RandomResizedCrop(16, **kw),
                             tt.RandomResizedCrop(
                                 16, rng=np.random.RandomState(seed), **kw),
                             x, seed)
            assert got.shape == (16, 16, 3)
            np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    r = np.random.RandomState(5)
    tc = tt.Compose([tt.RandomResizedCrop(24, rng=r),
                     tt.RandomFlipLeftRight(rng=r), tt.ToTensor(),
                     tt.Normalize(mean, std)])
    jc = jt.Compose([jt.RandomResizedCrop(24), jt.RandomFlipLeftRight(),
                     jt.ToTensor(), jt.Normalize(mean, std)])
    np.random.seed(5)
    for _ in range(4):
        got = tc(torch.tensor(x)).numpy()
        want = jc(jmx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-4 / 255 / 0.2)


def test_flips():
    rng = np.random.RandomState(3)
    x = _u8(rng, 6, 7, 3)
    for jb, tb in ((jt.RandomFlipLeftRight, tt.RandomFlipLeftRight),
                   (jt.RandomFlipTopBottom, tt.RandomFlipTopBottom)):
        np.random.seed(0)
        r = np.random.RandomState(0)
        t, j = tb(rng=r), jb()
        flipped = 0
        for _ in range(8):
            got = t(torch.tensor(x)).numpy()
            want = j(jmx.nd.array(x, dtype="uint8")).asnumpy()
            assert np.array_equal(got, want)
            flipped += not np.array_equal(got, x)
        assert 0 < flipped < 8
        with pytest.raises(ValueError, match="HWC"):
            t(torch.zeros(2, 3, 4, 3))


_COLOUR = [("RandomBrightness", (0.4,)), ("RandomContrast", (0.4,)),
           ("RandomSaturation", (0.4,)), ("RandomHue", (0.3,)),
           ("RandomLighting", (0.5,)), ("RandomGray", (0.5,))]


@pytest.mark.parametrize("name,args", _COLOUR)
def test_colour_transforms(name, args):
    rng = np.random.RandomState(4)
    x = _u8(rng, 9, 11, 3)
    for seed in range(3):
        got, want = _run(getattr(jt, name)(*args),
                         getattr(tt, name)(*args,
                                           rng=np.random.RandomState(seed)),
                         x.astype(np.float32), seed)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
        got, want = _run(getattr(jt, name)(*args),
                         getattr(tt, name)(*args,
                                           rng=np.random.RandomState(seed)),
                         x, seed)
        assert got.dtype == want.dtype == np.uint8
        _near_ties(got, want, share=0.05)


def test_colour_jitter_lighting_apply():
    rng = np.random.RandomState(5)
    x = _u8(rng, 9, 11, 3).astype(np.float32)
    kw = dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1)
    for seed in range(3):
        got, want = _run(jt.RandomColorJitter(**kw),
                         tt.RandomColorJitter(
                             rng=np.random.RandomState(seed), **kw), x, seed)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
        got, want = _run(jt.RandomApply(jt.RandomBrightness(0.5), 0.5),
                         tt.RandomApply(tt.RandomBrightness(
                             0.5, rng=np.random.RandomState(seed)), 0.5,
                             rng=np.random.RandomState(seed)), x, seed)
        assert got.shape == want.shape


def test_random_crop_with_pad():
    rng = np.random.RandomState(6)
    x = _u8(rng, 10, 12, 3)
    for kw in (dict(size=(6, 5)), dict(size=8, pad=2, pad_value=9),
               dict(size=(20, 20))):
        for seed in range(3):
            got, want = _run(jt.RandomCrop(**kw),
                             tt.RandomCrop(rng=pyrandom.Random(seed), **kw),
                             x, seed, py=True)
            assert got.shape == want.shape
            if kw["size"] != (20, 20):
                assert np.array_equal(got, want)
            else:
                _near_ties(got, want)


def test_rotate():
    rng = np.random.RandomState(7)
    x = _u8(rng, 13, 10, 3).astype(np.float32)
    for deg in (0.0, 30.0, -75.0, 180.0):
        got, want = _run(jt.Rotate(deg), tt.Rotate(deg), x)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for seed in range(2):
        got, want = _run(jt.RandomRotation((-40, 40)),
                         tt.RandomRotation((-40, 40),
                                           rng=np.random.RandomState(seed)),
                         x, seed)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError):
        tt.Rotate(10, zoom_in=True)


# ---- datasets -------------------------------------------------------------

@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_synthetic_sets(tmp_path, name):
    for train in (True, False):
        j = getattr(jds, name)(root=str(tmp_path), train=train,
                               synthetic_size=64)
        t = getattr(tds, name)(root=str(tmp_path), train=train,
                               synthetic_size=64)
        assert t.synthetic and j.synthetic and len(t) == len(j) == 64
        assert np.array_equal(t._data.numpy(), j._data.asnumpy())
        assert np.array_equal(t._label, j._label)
        img, lab = t[3]
        assert img.dtype == torch.uint8 and lab == j._label[3]


def test_mnist_and_cifar_files(tmp_path):
    rng = np.random.RandomState(8)
    imgs, labels = _u8(rng, 5, 28, 28), _u8(rng, 5) % 10
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    j = jds.MNIST(root=str(tmp_path), train=False)
    t = tds.MNIST(root=str(tmp_path), train=False,
                  transform=lambda d, l: (d.float(), l))
    assert not t.synthetic
    assert np.array_equal(t._data.numpy(), j._data.asnumpy())
    assert np.array_equal(t._label, j._label)
    assert t[2][0].dtype == torch.float32
    cdir = tmp_path / "cifar-10-batches-bin"
    cdir.mkdir()
    raw = np.concatenate([_u8(rng, 4, 1) % 10, _u8(rng, 4, 3072)], 1)
    (cdir / "test_batch.bin").write_bytes(raw.tobytes())
    j = jds.CIFAR10(root=str(tmp_path), train=False)
    t = tds.CIFAR10(root=str(tmp_path), train=False)
    assert np.array_equal(t._data.numpy(), j._data.asnumpy())
    assert np.array_equal(t._label, j._label)


def test_image_folder_dataset(tmp_path):
    import shutil
    files = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    for i, f in enumerate(files[:6]):
        cls = tmp_path / f"class{i % 2}"
        cls.mkdir(exist_ok=True)
        shutil.copy(os.path.join(FIXTURES, f), cls / f)
    (tmp_path / "notes.txt").write_text("not a class")
    j = jds.ImageFolderDataset(str(tmp_path))
    t = tds.ImageFolderDataset(str(tmp_path), device="cpu")
    assert t.synsets == j.synsets == ["class0", "class1"]
    assert [(os.path.basename(a), b) for a, b in t.items] == \
        [(os.path.basename(a), b) for a, b in j.items]
    for i in range(len(t)):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert tl == jl and np.array_equal(ti.numpy(), ji.asnumpy())
    assert not t.decodes_on_cuda
    loader = data.DataLoader(
        t.transform_first(tt.Compose([tt.Resize(16), tt.ToTensor()])),
        batch_size=3)
    x, y = next(iter(loader))
    assert tuple(x.shape) == (3, 3, 16, 16) and y.tolist() == [0, 0, 0]


def test_dataloader_refuses_card_decode_in_processes():
    class CardDecode(data.Dataset):
        decodes_on_cuda = True

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return i

    wrapped = CardDecode().transform(lambda v: v)
    with pytest.raises(ValueError, match="process worker"):
        data.DataLoader(wrapped, batch_size=2, num_workers=2,
                        thread_pool=False)
    assert len(list(data.DataLoader(wrapped, batch_size=2, num_workers=2))) \
        == 2
