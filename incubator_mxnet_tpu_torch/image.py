"""Image decoding and augmentation (counterpart of
``incubator_mxnet_tpu/image.py``; reference ``python/mxnet/image/``).

An image is a ``torch.Tensor``, HWC, on any device.  Decoding:

* on a CUDA device, :func:`imdecode` decodes JPEG with nvJPEG into
  device memory (``ops/jpeg_decode.py``); PNG and other formats, grey
  output (``flag=0``) and :func:`imencode` of a CUDA tensor raise,
  naming what is missing, and nothing goes quietly to the host;
* on the CPU (``device="cpu"``), with cv2, else PIL, exactly as the JAX
  package's ``_decode_bytes`` does; with neither it raises.

Entry points that decode (:func:`imdecode`, :func:`imread`,
:class:`ImageIter`) run on ``cuda:0`` unless given ``device``; the
augmenters run where their input lies.

The resizes are the JAX package's, ``jax.image.resize(..., "bilinear")``
with its default antialiasing (``ops/image_ops.resize``), cast back to
the input's dtype as XLA casts; the ``interp`` arguments are accepted
and ignored, as there.  The random augmenters draw from an explicit
``random.Random`` (``rng``), by default :data:`random.py_rng`, where the
JAX package draws from Python's global stream, and the detection
augmenters from a ``numpy.random.RandomState``, by default
:data:`random.np_rng`; seeded alike they draw the same numbers.
"""
from __future__ import annotations

import io as _io

import numpy as np
import torch

from . import random as _random
from . import recordio
from .context import resolve_device
from .ops import image_ops, jpeg_decode

__all__ = ["imread", "imdecode", "imdecode_np", "imencode", "imresize",
           "resize_short", "center_crop", "random_crop", "fixed_crop",
           "color_normalize", "CreateAugmenter", "Augmenter", "ResizeAug",
           "CenterCropAug", "RandomCropAug", "HorizontalFlipAug",
           "ColorNormalizeAug", "ImageIter", "DetAugmenter",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetBorderAug",
           "DetColorNormalizeAug", "CreateDetAugmenter", "ImageDetIter"]


def _decode_bytes(buf: bytes, flag=1):
    """HWC uint8 numpy (H x W for grey through cv2) of an encoded image,
    by cv2 or else PIL."""
    try:
        import cv2
        arr = np.frombuffer(buf, dtype=np.uint8)
        img = cv2.imdecode(arr, 1 if flag else 0)
        if img is None:
            raise ValueError("cv2 failed to decode image")
        if flag:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("no image decoder available (cv2/PIL)") from e
    img = Image.open(_io.BytesIO(buf))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img)
    if not flag:
        arr = arr[..., None]
    return arr


def imdecode_np(buf, flag=1):
    """The image as a numpy array, decoded on the host."""
    return _decode_bytes(bytes(buf), flag)


def imdecode(buf, flag=1, to_rgb=True, out=None, device=None):
    """Decode an encoded image → uint8 HWC tensor on ``device``
    (``cuda:0`` unless given): nvJPEG on the card, cv2/PIL on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        if not flag:
            raise NotImplementedError(
                "grey decode (flag=0) on the card is not ported; decode "
                "with flag=1")
        return jpeg_decode.decode(bytes(buf), device)
    return torch.from_numpy(np.ascontiguousarray(
        _decode_bytes(bytes(buf), flag)))


def imencode(img, fmt=".jpg", quality=95) -> bytes:
    """Encode an HWC uint8 image on the host (cv2, else PIL).  A CUDA
    tensor raises: nvJPEG's encoder is not ported."""
    if isinstance(img, torch.Tensor):
        if img.device.type != "cpu":
            raise NotImplementedError(
                "image encode on the card (nvJPEG's encoder) is not ported; "
                "encode a CPU image")
        img = img.numpy()
    img = np.asarray(img, dtype=np.uint8)
    try:
        import cv2
        ok, buf = cv2.imencode(fmt, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise ValueError("cv2 encode failed")
        return bytes(buf)
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("no image encoder available (cv2/PIL)") from e
    bio = _io.BytesIO()
    Image.fromarray(img.squeeze() if img.shape[-1] == 1 else img).save(
        bio, format="JPEG" if fmt in (".jpg", ".jpeg") else "PNG",
        quality=quality)
    return bio.getvalue()


def imread(filename, flag=1, to_rgb=True, device=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb, device=device)


def _tensor(src):
    return src if isinstance(src, torch.Tensor) else \
        torch.as_tensor(np.asarray(src))


def imresize(src, w, h, interp=1):
    """``src`` (HWC) resized to (h, w) by ``jax.image.resize``'s bilinear
    with antialiasing, in float32, cast back to ``src``'s dtype."""
    src = _tensor(src)
    out = image_ops.resize(src.float(), (h, w, src.shape[2]), "linear")
    return image_ops.cast_like_xla(out, src.dtype)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _tensor(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != tuple(size):
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                      interp), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2, rng=None):
    """A crop of ``size`` (w, h) at a corner drawn from ``rng`` (a
    ``random.Random``; :data:`random.py_rng` by default), resized to
    ``size`` where the image is smaller."""
    rng = rng or _random.py_rng
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = rng.randint(0, w - new_w)
    y0 = rng.randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = _tensor(src)
    out = src.float() - torch.as_tensor(np.asarray(mean, np.float32),
                                        device=src.device)
    if std is not None:
        out = out / torch.as_tensor(np.asarray(std, np.float32),
                                    device=src.device)
    return out


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2, rng=None):
        super().__init__(size=size)
        self.size = size
        self.rng = rng

    def __call__(self, src):
        return random_crop(src, self.size, rng=self.rng)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng

    def __call__(self, src):
        if (self.rng or _random.py_rng).random() < self.p:
            return torch.flip(src, [1])
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2, rng=None):
    """The standard chain: resize of the short side, a random or centre
    crop, a random mirror, colour normalisation.  The JAX package
    accepts the colour and random-resize options and ignores them; the
    port refuses them (use the vision transforms)."""
    ignored = {k: v for k, v in dict(
        rand_resize=rand_resize, brightness=brightness, contrast=contrast,
        saturation=saturation, hue=hue, pca_noise=pca_noise,
        rand_gray=rand_gray).items() if v}
    if ignored:
        raise NotImplementedError(
            f"CreateAugmenter options {sorted(ignored)} are not implemented "
            "(the JAX package ignores them); use "
            "gluon.data.vision.transforms")
    auglist: list[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method, rng=rng))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5, rng=rng))
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(
            mean if mean is not None else [0, 0, 0],
            std if std is not None else [1, 1, 1]))
    return auglist


class ImageIter:
    """Batches of decoded, augmented images from a RecordIO file
    (reference ``image.py ImageIter``): data (B, C, H, W) float32 and
    label float32 on ``device`` (``cuda:0`` unless given).  Records hold
    encoded images; a raw ``b"MXTR"`` record fails to decode, as in the
    JAX iterator (``ImageRecordIter`` reads both).  The last partial
    batch is dropped.  ``shuffle`` reorders
    with ``rng`` (a ``random.Random``, :data:`random.py_rng` by
    default).  ``path_imglist`` and unknown keyword arguments raise
    (the JAX iterator ignores them)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, device=None, rng=None,
                 **kwargs):
        if kwargs:
            raise TypeError(f"ImageIter: unknown arguments {sorted(kwargs)}")
        if path_imglist:
            raise NotImplementedError(
                "ImageIter: path_imglist is not implemented (the JAX "
                "iterator ignores it); pack the images with path_imgrec")
        import os
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter((3,) + self.data_shape[1:], rng=rng)
        self._rng = rng
        self._records = []
        if path_imgrec:
            idx_path = path_imgrec[:path_imgrec.rfind(".")] + ".idx"
            if os.path.exists(idx_path):
                rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self._records = [rec.read_idx(k) for k in rec.keys]
            else:
                rec = recordio.MXRecordIO(path_imgrec, "r")
                while True:
                    buf = rec.read()
                    if buf is None:
                        break
                    self._records.append(buf)
            rec.close()
        self._order = list(range(len(self._records)))
        self._shuffle = shuffle
        self._cursor = 0
        self.reset()

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            (self._rng or _random.py_rng).shuffle(self._order)

    def __iter__(self):
        return self

    def __next__(self):
        from .io import DataBatch
        if self._cursor + self.batch_size > len(self._records):
            raise StopIteration
        imgs, labels = [], []
        for i in range(self.batch_size):
            buf = self._records[self._order[self._cursor + i]]
            header, img_buf = recordio.unpack(buf)
            img = imdecode(img_buf, device=self.device)
            for aug in self.auglist:
                img = aug(img)
            imgs.append(img.permute(2, 0, 1).float())
            labels.append(header.label)
        self._cursor += self.batch_size
        data = torch.stack(imgs, dim=0)
        label = torch.as_tensor(np.asarray(labels, np.float32),
                                device=self.device)
        return DataBatch(data=[data], label=[label])

    next = __next__


# ---------------------------------------------------------------------------
# detection (reference python/mxnet/image/detection.py): label rows are
# [class, xmin, ymin, xmax, ymax], coordinates normalised to [0, 1],
# numpy float32 on the host; images are tensors on any device.
# ---------------------------------------------------------------------------

class DetAugmenter:
    """Augmenter transforming (image, label) together."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability ``p``."""

    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = rng

    def __call__(self, src, label):
        if (self.rng or _random.np_rng).rand() < self.p:
            src = torch.flip(src, [1])
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop that keeps at least ``min_object_covered`` of every
    object it cuts, within ``max_attempts`` draws (else the input)."""

    def __init__(self, min_object_covered=0.5, min_crop_size=0.5,
                 max_attempts=25, rng=None):
        self.min_object_covered = min_object_covered
        self.min_crop_size = min_crop_size
        self.max_attempts = max_attempts
        self.rng = rng

    def __call__(self, src, label):
        rng = self.rng or _random.np_rng
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            cw = rng.uniform(self.min_crop_size, 1.0)
            ch = rng.uniform(self.min_crop_size, 1.0)
            cx = rng.uniform(0, 1.0 - cw)
            cy = rng.uniform(0, 1.0 - ch)
            new = self._project(label, cx, cy, cw, ch)
            if new is not None:
                x0, y0 = int(cx * w), int(cy * h)
                x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
                return src[y0:y1, x0:x1], new
        return src, label

    def _project(self, label, cx, cy, cw, ch):
        """Boxes in crop coordinates; None if an object is cut below
        ``min_object_covered`` or none is left."""
        out = []
        for row in label:
            cls, xmin, ymin, xmax, ymax = row[:5]
            ix0, iy0 = max(xmin, cx), max(ymin, cy)
            ix1, iy1 = min(xmax, cx + cw), min(ymax, cy + ch)
            inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
            area = (xmax - xmin) * (ymax - ymin)
            if area <= 0 or inter / area < 1e-6:
                continue                      # object fully outside: drop
            if inter / area < self.min_object_covered:
                return None                   # partially cut: reject crop
            out.append([cls,
                        max(0.0, (xmin - cx) / cw),
                        max(0.0, (ymin - cy) / ch),
                        min(1.0, (xmax - cx) / cw),
                        min(1.0, (ymax - cy) / ch)])
        if not out:
            return None
        return np.asarray(out, np.float32)


class DetBorderAug(DetAugmenter):
    """Pad to a square with ``fill``, the image centred, boxes
    renormalised."""

    def __init__(self, fill=127):
        self.fill = fill

    def __call__(self, src, label):
        h, w = src.shape[:2]
        s = max(h, w)
        out = torch.full((s, s) + tuple(src.shape[2:]), self.fill,
                         dtype=src.dtype, device=src.device)
        y0, x0 = (s - h) // 2, (s - w) // 2
        out[y0:y0 + h, x0:x0 + w] = src
        label = label.copy()
        label[:, [1, 3]] = (label[:, [1, 3]] * w + x0) / s
        label[:, [2, 4]] = (label[:, [2, 4]] * h + y0) / s
        return out, label


class DetColorNormalizeAug(DetAugmenter):
    """Colour normalisation of the image; labels pass through."""

    def __init__(self, mean, std=None):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src, label):
        out = src.float() - torch.as_tensor(self.mean, device=src.device)
        if self.std is not None:
            out = out / torch.as_tensor(self.std, device=src.device)
        return out, label


def CreateDetAugmenter(data_shape, rand_crop=0, rand_mirror=False,
                       rand_pad=0, mean=None, std=None, rng=None):
    """The standard detection chain: pad, crop, mirror, normalise."""
    augs: list = []
    if rand_pad:
        augs.append(DetBorderAug())
    if rand_crop:
        augs.append(DetRandomCropAug(rng=rng))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(rng=rng))
    if mean is not None:
        augs.append(DetColorNormalizeAug(mean, std))
    return augs


class ImageDetIter:
    """Detection batches with padded multi-object labels (reference
    ``image/detection.py ImageDetIter``).  ``imglist``: (HWC image, label
    rows (N, 5)) pairs.  Each batch: data (B, C, H, W) float32 and label
    (B, max_objs, 5) padded with -1 rows, on ``device`` (``cuda:0``
    unless given); the last batch wraps to the start and ``pad`` counts
    the wrapped slots.  ``shuffle`` draws from ``rng`` (a
    ``numpy.random.RandomState``, :data:`random.np_rng` by default)."""

    def __init__(self, batch_size, data_shape, imglist, augmenters=None,
                 shuffle=False, label_shape=None, device=None, rng=None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self._items = list(imglist)
        self._augs = augmenters or []
        self._shuffle = shuffle
        self._rng = rng
        self._order = list(range(len(self._items)))
        self._cursor = 0
        if label_shape is not None:
            self._max_objs = int(label_shape[0])
        else:
            self._max_objs = max(
                (np.asarray(lab).reshape(-1, 5).shape[0]
                 for _, lab in self._items), default=1)
        self.reset()

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            (self._rng or _random.np_rng).shuffle(self._order)

    def __iter__(self):
        return self

    def __next__(self):
        from .io import DataBatch
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        idxs = [self._order[(self._cursor + i) % n]
                for i in range(self.batch_size)]
        pad = max(0, self._cursor + self.batch_size - n)
        self._cursor += self.batch_size
        c, h, w = self.data_shape
        datas, labels = [], []
        for i in idxs:
            img, lab = self._items[i]
            img = _tensor(img).to(self.device)
            lab = np.asarray(lab, np.float32).reshape(-1, 5)
            for aug in self._augs:
                img, lab = aug(img, lab)
            img = imresize(img, w, h)
            datas.append(img.float().permute(2, 0, 1))
            labels.append(lab)
        lab_out = np.full((self.batch_size, self._max_objs, 5), -1.0,
                          np.float32)
        for bi, lab in enumerate(labels):
            k = min(len(lab), self._max_objs)
            lab_out[bi, :k] = lab[:k]
        return DataBatch(data=[torch.stack(datas)],
                         label=[torch.as_tensor(lab_out, device=self.device)],
                         pad=pad)

    next = __next__
