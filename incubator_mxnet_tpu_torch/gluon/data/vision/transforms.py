"""Vision transforms (counterpart of
``incubator_mxnet_tpu/gluon/data/vision/transforms.py``; reference
``gluon/data/vision/transforms.py``).

Each transform is a block whose forward takes an HWC image (or, where
the JAX one does, an NHWC batch) as a tensor on any device and returns
one on the same device.  The resizes are ``jax.image.resize``'s
bilinear with antialiasing (``ops/image_ops.resize``), cast back to the
input's dtype as XLA casts.  The random transforms draw from ``rng``, a
``numpy.random.RandomState`` (:data:`random.np_rng` by default) where
the JAX ones draw from numpy's global stream, and ``RandomCrop`` from a
``random.Random`` (:data:`random.py_rng`), as ``image.random_crop``
does; seeded alike, the draws are the JAX package's call for call.

Differences from the JAX package, each refused rather than copied
(ROADMAP §C): the flips raise on anything but an HWC image (the JAX
ones return a batch unflipped), and ``Resize(keep_ratio=True)`` raises
(the JAX one ignores it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .... import random as _random
from ....ops import image_ops
from ...block import HybridBlock
from ...nn import HybridSequential

__all__ = ["Compose", "HybridCompose", "Cast", "ToTensor", "Normalize",
           "Resize", "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomGray", "RandomCrop", "CropResize",
           "Rotate", "RandomRotation", "RandomApply", "HybridRandomApply"]

_GRAY = np.array([0.299, 0.587, 0.114], "float32")
_YIQ = np.array([[0.299, 0.587, 0.114],
                 [0.596, -0.274, -0.321],
                 [0.211, -0.523, 0.311]], "float32")
_YIQ_INV = np.linalg.inv(_YIQ).astype("float32")


def _f32(v):
    """A numpy or Python scalar rounded to float32, as JAX rounds it
    where it meets a float32 array."""
    return float(np.float32(v))


def _np(rng):
    return rng or _random.np_rng


def _const(arr, like):
    return torch.as_tensor(np.asarray(arr, np.float32), device=like.device)


def _back(x, like):
    """``x`` clipped to [0, 255] and cast to ``like``'s dtype."""
    return image_ops.cast_like_xla(x.clamp(0, 255), like.dtype)


class Compose(HybridSequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


HybridCompose = Compose


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = getattr(torch, str(dtype))

    def forward(self, x):
        return image_ops.cast_like_xla(x, self._dtype)


class ToTensor(HybridBlock):
    """HWC [0, 255] → CHW float32 [0, 1]; NHWC → NCHW.  The JAX
    transform's division by 255 runs as a product with float32(1/255)."""

    def forward(self, x):
        y = x.float() * _f32(1.0 / 255.0)
        return y.permute(2, 0, 1) if x.dim() == 3 else y.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    """(x - mean) / std per channel of CHW / NCHW float tensors."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, "float32").reshape(-1, 1, 1)
        self._std = np.asarray(std, "float32").reshape(-1, 1, 1)

    def forward(self, x):
        return (x - _const(self._mean, x)) / _const(self._std, x)


def _resize(x, size):
    w, h = size
    shape = (h, w, x.shape[2]) if x.dim() == 3 else \
        (x.shape[0], h, w, x.shape[3])
    return image_ops.cast_like_xla(
        image_ops.resize(x.float(), shape, "linear"), x.dtype)


class Resize(HybridBlock):
    """Resize to ``size`` (w, h) by ``jax.image.resize``'s antialiased
    bilinear.  ``interpolation`` is ignored, as in the JAX package."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        if keep_ratio:
            raise NotImplementedError(
                "Resize(keep_ratio=True) is not implemented (the JAX "
                "package ignores it)")
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        return _resize(x, self._size)


class CenterCrop(HybridBlock):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0, x0 = max((H - h) // 2, 0), max((W - w) // 2, 0)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(HybridBlock):
    """A crop of random area (``scale`` of the image) and aspect
    (``ratio``), resized to ``size``; after 10 draws that do not fit,
    the whole image resized, as in the JAX package."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1, rng=None):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._rng = rng

    def forward(self, x):
        rng = _np(self._rng)
        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        for _ in range(10):
            target = rng.uniform(*self._scale) * area
            ar = rng.uniform(*self._ratio)
            w = int(round((target * ar) ** 0.5))
            h = int(round((target / ar) ** 0.5))
            if w <= W and h <= H:
                x0 = rng.randint(0, W - w + 1)
                y0 = rng.randint(0, H - h + 1)
                return _resize(x[..., y0:y0 + h, x0:x0 + w, :], self._size)
        return _resize(x, self._size)


def _hwc(name, x):
    if x.dim() != 3:
        raise ValueError(f"{name} takes an HWC image, got shape "
                         f"{tuple(x.shape)} (the JAX transform returns a "
                         "batch unflipped)")


class RandomFlipLeftRight(HybridBlock):
    def __init__(self, rng=None):
        super().__init__()
        self._rng = rng

    def forward(self, x):
        _hwc("RandomFlipLeftRight", x)
        if _np(self._rng).rand() < 0.5:
            return torch.flip(x, [1])
        return x


class RandomFlipTopBottom(HybridBlock):
    def __init__(self, rng=None):
        super().__init__()
        self._rng = rng

    def forward(self, x):
        _hwc("RandomFlipTopBottom", x)
        if _np(self._rng).rand() < 0.5:
            return torch.flip(x, [0])
        return x


class RandomBrightness(HybridBlock):
    def __init__(self, brightness, rng=None):
        super().__init__()
        self._b = brightness
        self._rng = rng

    def forward(self, x):
        alpha = 1.0 + _np(self._rng).uniform(-self._b, self._b)
        return _back(x.float() * _f32(alpha), x)


def _luma(f):
    """The per-pixel 0.299 r + 0.587 g + 0.114 b of float32 HWC ``f``."""
    return f @ _const(_GRAY, f)


class RandomContrast(HybridBlock):
    """Blend with the mean luminance: f·α + mean(luma)·(1 - α)."""

    def __init__(self, contrast, rng=None):
        super().__init__()
        self._c = contrast
        self._rng = rng

    def forward(self, x):
        alpha = 1.0 + _np(self._rng).uniform(-self._c, self._c)
        f = x.float()
        lum_mean = float(_luma(f).mean())
        return _back(f * _f32(alpha) + _f32(lum_mean * (1 - alpha)), x)


class RandomSaturation(HybridBlock):
    """Blend with the per-pixel grey: f·α + luma·(1 - α)."""

    def __init__(self, saturation, rng=None):
        super().__init__()
        self._s = saturation
        self._rng = rng

    def forward(self, x):
        alpha = 1.0 + _np(self._rng).uniform(-self._s, self._s)
        f = x.float()
        gray = _luma(f)[..., None]
        return _back(f * _f32(alpha) + gray * _f32(1 - alpha), x)


class RandomHue(HybridBlock):
    """Rotate the hue through the YIQ linear approximation."""

    def __init__(self, hue, rng=None):
        super().__init__()
        self._h = hue
        self._rng = rng

    def forward(self, x):
        alpha = _np(self._rng).uniform(-self._h, self._h) * np.pi
        u, w = np.cos(alpha), np.sin(alpha)
        t_hue = np.array([[1.0, 0.0, 0.0],
                          [0.0, u, -w],
                          [0.0, w, u]], "float32")
        t_rgb = _YIQ_INV @ t_hue @ _YIQ
        out = x.float() @ _const(t_rgb.T, x)
        return _back(out, x)


class RandomColorJitter(HybridBlock):
    """Brightness, contrast, saturation and hue, in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng=None):
        super().__init__()
        self._rng = rng
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness, rng))
        if contrast:
            self._ts.append(RandomContrast(contrast, rng))
        if saturation:
            self._ts.append(RandomSaturation(saturation, rng))
        if hue:
            self._ts.append(RandomHue(hue, rng))

    def forward(self, x):
        for i in _np(self._rng).permutation(len(self._ts)):
            x = self._ts[int(i)].forward(x)
        return x


class RandomLighting(HybridBlock):
    """AlexNet-style PCA lighting noise."""

    _eigval = np.array([55.46, 4.794, 1.148], "float32")
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], "float32")

    def __init__(self, alpha, rng=None):
        super().__init__()
        self._a = alpha
        self._rng = rng

    def forward(self, x):
        alpha = _np(self._rng).normal(0, self._a, 3).astype("float32")
        rgb = (self._eigvec * alpha) @ self._eigval
        return _back(x.float() + _const(rgb, x), x)


class RandomGray(HybridBlock):
    """Grey in all three channels with probability ``p``."""

    def __init__(self, p=0.5, rng=None):
        super().__init__()
        self._p = p
        self._rng = rng

    def forward(self, x):
        if _np(self._rng).rand() < self._p:
            gray = _luma(x.float())[..., None]
            return _back(torch.cat([gray, gray, gray], dim=-1), x)
        return x


class RandomCrop(HybridBlock):
    """A crop at a random position after optional padding, resized up
    where the padded image is smaller (``image.random_crop``, whose
    corner comes from ``rng``, a ``random.Random``).  HWC only."""

    def __init__(self, size, pad=None, pad_value=0, interpolation=1,
                 rng=None):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._pad_value = pad_value
        self._interp = interpolation
        self._rng = rng

    def forward(self, x):
        from .... import image
        if x.dim() != 3:
            raise ValueError("RandomCrop expects an HWC image; use "
                             "CenterCrop for batched input")
        if self._pad:
            p = self._pad
            x = torch.nn.functional.pad(x.permute(2, 0, 1), (p, p, p, p),
                                        value=self._pad_value).permute(1, 2, 0)
        out, _ = image.random_crop(x, self._size, interp=self._interp,
                                   rng=self._rng)
        return out


class CropResize(HybridBlock):
    """A fixed crop, then a resize to ``size`` if given."""

    def __init__(self, x0, y0, width, height, size=None, interpolation=1):
        super().__init__()
        self._box = (x0, y0, width, height)
        self._size = size
        self._interp = interpolation

    def forward(self, x):
        x0, y0, w, h = self._box
        crop = x[..., y0:y0 + h, x0:x0 + w, :]
        if self._size is not None:
            size = (self._size, self._size) if isinstance(self._size, int) \
                else tuple(self._size)
            return _resize(crop, size)
        return crop


def _map_coordinates(f, ys, xs):
    """Order-1 ``map_coordinates`` of an HW float32 plane at (ys, xs),
    zero outside (``jax.scipy.ndimage.map_coordinates`` with ``cval=0``):
    each of the four taps weighs in if it lies inside."""
    H, W = f.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    out = torch.zeros_like(ys)
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            iy, ix = (y0 + dy).long(), (x0 + dx).long()
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            val = f[iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
            out = out + torch.where(valid, val, torch.zeros_like(val)) \
                * (wgt_y * wgt_x)
    return out


class Rotate(HybridBlock):
    """Rotate an HWC image by ``rotation_degrees`` about its centre,
    bilinear, corners zero.  ``zoom_in``/``zoom_out`` raise."""

    def __init__(self, rotation_degrees=None, zoom_in=False, zoom_out=False,
                 rotation=None):
        super().__init__()
        if zoom_in or zoom_out:
            raise NotImplementedError(
                "Rotate zoom_in/zoom_out are not implemented; rotate "
                "then Resize/CenterCrop explicitly")
        deg = rotation_degrees if rotation_degrees is not None else rotation
        self._theta = float(np.deg2rad(deg if deg is not None else 0.0))

    def _rotate(self, x, theta):
        f = x.float()
        H, W = f.shape[0], f.shape[1]
        cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        yy, xx = torch.meshgrid(
            torch.arange(H, device=x.device, dtype=torch.float32) - _f32(cy),
            torch.arange(W, device=x.device, dtype=torch.float32) - _f32(cx),
            indexing="ij")
        c, s = _f32(math.cos(theta)), _f32(math.sin(theta))
        src_y = _f32(cy) + yy * c - xx * s
        src_x = _f32(cx) + yy * s + xx * c
        out = torch.stack([_map_coordinates(f[..., ch], src_y, src_x)
                           for ch in range(f.shape[-1])], dim=-1)
        return image_ops.cast_like_xla(out, x.dtype)

    def forward(self, x):
        return self._rotate(x, self._theta)


class RandomRotation(Rotate):
    """Rotate by an angle drawn from ``angle_limits`` degrees, with
    probability ``rotate_with_proba``."""

    def __init__(self, angle_limits=(-10, 10), zoom_in=False,
                 zoom_out=False, rotate_with_proba=1.0, rng=None):
        super().__init__(rotation_degrees=0.0, zoom_in=zoom_in,
                         zoom_out=zoom_out)
        self._limits = angle_limits
        self._proba = rotate_with_proba
        self._rng = rng

    def forward(self, x):
        rng = _np(self._rng)
        if rng.rand() >= self._proba:
            return x
        deg = rng.uniform(*self._limits)
        return self._rotate(x, float(np.deg2rad(deg)))


class RandomApply(HybridBlock):
    """``transforms`` with probability ``p``."""

    def __init__(self, transforms, p=0.5, rng=None):
        super().__init__()
        self._t = transforms
        self._p = p
        self._rng = rng

    def forward(self, x):
        if _np(self._rng).rand() < self._p:
            return self._t(x)
        return x


HybridRandomApply = RandomApply
