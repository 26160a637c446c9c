"""Image operators (counterpart of ``incubator_mxnet_tpu/ops/image_ops.py``;
reference ``src/operator/image/`` and the contrib image and box ops).

Plain PyTorch on any device.  ``image_*`` ops take HWC images or NHWC
batches, ``image_to_tensor`` turns them into CHW (NCHW) float32.

The resizes keep the JAX package's semantics, which are those of
``jax.image.resize``: a separable resampling whose weight matrices are
built as ``jax/_src/image/scale.py``'s ``compute_weight_mat`` builds
them (half-pixel centres, the kernel widened by the scale when
antialiasing a downsample, each column normalised to sum 1, columns
sampling outside the input zeroed) and applied by two ``einsum``s in
float32.  :func:`resize` is that function; ``F.interpolate`` is not.
A result cast back to an integer dtype saturates to the dtype's range
and truncates, as XLA's conversion does (``Tensor.to`` wraps instead).

The random ops take an explicit generator: ``image_random_crop`` a
``torch.Generator`` where the JAX op takes a PRNG key (the two draw
other numbers); ``image_random_resized_crop`` a ``seed`` for a
``numpy.random.RandomState``, as the JAX op does, so that both draw the
same window.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["resize", "cast_like_xla", "image_crop", "image_resize",
           "image_to_tensor", "image_normalize", "image_random_crop",
           "bilinear_resize_2d", "box_encode", "box_decode", "allclose",
           "arange_like", "quadratic", "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt", "image_random_resized_crop"]

_EPS32 = float(np.finfo(np.float32).eps)


def _f32(v):
    """A Python float rounded to float32, as JAX rounds a weak-typed
    scalar that meets a float32 array."""
    return float(np.float32(v))


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius):
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        denom = torch.where(x != 0, _f32(math.pi ** 2) * x * x,
                            torch.ones_like(x))
        out = torch.where(x > 1e-3, y / denom, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "triangle": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic, "lanczos3": _lanczos(3.0),
            "lanczos5": _lanczos(5.0)}


def _weight_mat(in_size, out_size, kernel, antialias, device):
    """``(in_size, out_size)`` float32 weights of one spatial dimension
    (``compute_weight_mat`` with scale out/in and no translation)."""
    inv_scale = _f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[None, :] - src[:, None]).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize_nearest(x, shape):
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        # XLA folds "* m / n" into one float32 constant, m · (1/n)
        step = _f32(np.float32(m) * np.float32(1.0 / n))
        offsets = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * step
        x = x.index_select(d, torch.floor(offsets).long())
    return x


def resize(x, shape, method="linear", antialias=True):
    """``jax.image.resize(x, shape, method, antialias)`` in float32 (an
    integer ``x`` is computed as float32 and returned as float32)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} does not match the input's rank "
                         f"{x.dim()}")
    if method == "nearest":
        return _resize_nearest(x, shape)
    if method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    kernel = _KERNELS[method]
    out = x if x.is_floating_point() else x.float()
    out = out.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        w = _weight_mat(m, n, kernel, antialias, x.device)
        out = torch.tensordot(out, w, dims=([d], [0])).movedim(-1, d)
    return out.contiguous()


def cast_like_xla(x, dtype):
    """``x.astype(dtype)`` as XLA converts: float to an integer type
    truncates toward zero and saturates at the type's range."""
    dtype = x.dtype if dtype is None else dtype
    if x.is_floating_point() and not dtype.is_floating_point \
            and dtype != torch.bool:
        info = torch.iinfo(dtype)
        return x.clamp(info.min, info.max).trunc().to(dtype)
    return x.to(dtype)


def _is_batch(x):
    return x.dim() == 4


def image_crop(x, x_start=0, y_start=0, width=1, height=1):
    """Fixed-window crop of HWC / NHWC images."""
    if _is_batch(x):
        return x[:, y_start:y_start + height, x_start:x_start + width, :]
    return x[y_start:y_start + height, x_start:x_start + width, :]


_INTERP = {0: ("nearest", False), 1: ("linear", False), 2: ("cubic", False),
           3: ("linear", True), 4: ("lanczos3", False)}


def image_resize(x, size=None, keep_ratio=False, interp=1):
    """Resize HWC / NHWC.  ``size``: int or (w, h); ``keep_ratio`` with
    an int size scales the short edge to it.  ``interp``: 0 nearest, 1
    bilinear, 2 bicubic, 3 area (antialiased bilinear), 4 lanczos3, as
    the JAX op maps OpenCV's codes."""
    if size is None:
        raise ValueError("image_resize requires size")
    if isinstance(size, int):
        if keep_ratio:
            src_h, src_w = (x.shape[1], x.shape[2]) if _is_batch(x) else \
                (x.shape[0], x.shape[1])
            if src_h < src_w:
                size = (max(1, round(src_w * size / src_h)), size)
            else:
                size = (size, max(1, round(src_h * size / src_w)))
        else:
            size = (size, size)
    w, h = int(size[0]), int(size[1])
    method, antialias = _INTERP.get(interp, ("linear", False))
    if _is_batch(x):
        new_shape = (x.shape[0], h, w, x.shape[3])
    else:
        new_shape = (h, w, x.shape[2])
    return cast_like_xla(resize(x.float(), new_shape, method, antialias),
                         x.dtype)


def image_to_tensor(x):
    """HWC uint8 [0, 255] → CHW float32 [0, 1]; NHWC → NCHW."""
    y = x.float() / 255.0
    if _is_batch(x):
        return y.permute(0, 3, 1, 2)
    return y.permute(2, 0, 1)


def image_normalize(x, mean=0.0, std=1.0):
    """(x - mean) / std per channel of CHW / NCHW tensors."""
    mean_t = torch.as_tensor(np.asarray(mean, np.float32),
                             device=x.device).reshape(-1, 1, 1)
    std_t = torch.as_tensor(np.asarray(std, np.float32),
                            device=x.device).reshape(-1, 1, 1)
    return cast_like_xla((x - mean_t) / std_t, x.dtype)


def image_random_crop(x, width=1, height=1, generator=None):
    """Crop to (height, width) at a position drawn uniformly from
    ``generator`` (a ``torch.Generator`` on the CPU)."""
    if _is_batch(x):
        hmax, wmax = x.shape[1] - height, x.shape[2] - width
    else:
        hmax, wmax = x.shape[0] - height, x.shape[1] - width
    if hmax < 0 or wmax < 0:
        raise ValueError(f"crop ({height}, {width}) larger than the image")
    y0 = int(torch.randint(0, hmax + 1, (), generator=generator))
    x0 = int(torch.randint(0, wmax + 1, (), generator=generator))
    return image_crop(x, x0, y0, width, height)


def bilinear_resize_2d(data, like=None, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size", align_corners=True):
    """NCHW bilinear resize (contrib ``BilinearResize2D``): the JAX op's
    modes and shape arithmetic, align-corners or half-pixel sampling."""
    n, c, h, w = data.shape
    if mode == "size":
        out_h = int(scale_height * h) if scale_height is not None \
            else int(height)
        out_w = int(scale_width * w) if scale_width is not None \
            else int(width)
    elif mode == "odd_scale":
        out_h = int(h * scale_height) if h % 2 == 0 \
            else int((h - 1) * scale_height) + 1
        out_w = int(w * scale_width) if w % 2 == 0 \
            else int((w - 1) * scale_width) + 1
    elif mode == "like":
        if like is None:
            raise ValueError("mode='like' needs the second (like) input")
        out_h, out_w = like.shape[-2], like.shape[-1]
    elif mode in ("to_even_down", "to_even_up", "to_odd_down", "to_odd_up"):
        odd, down = "odd" in mode, mode.endswith("down")

        def _round(dim):
            if (dim % 2 == 1) == odd:
                return dim
            return dim - 1 if down else dim + 1
        out_h, out_w = _round(h), _round(w)
    else:
        raise ValueError(f"unknown BilinearResize2D mode {mode!r}")

    def coords(out_dim, in_dim):
        if out_dim == 1:
            return torch.zeros(1, dtype=torch.float32, device=data.device)
        ar = torch.arange(out_dim, dtype=torch.float32, device=data.device)
        if align_corners:
            return ar * _f32((in_dim - 1) / (out_dim - 1))
        return torch.clamp((ar + 0.5) * _f32(in_dim / out_dim) - 0.5,
                           min=0.0)

    ys, xs = coords(out_h, h), coords(out_w, w)
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = ys - y0.float()
    wx = xs - x0.float()
    d = data.float()
    dy0, dy1 = d[:, :, y0], d[:, :, y1]
    top = dy0[:, :, :, x0] * (1 - wx) + dy0[:, :, :, x1] * wx
    bot = dy1[:, :, :, x0] * (1 - wx) + dy1[:, :, :, x1] * wx
    out = top * (1 - wy)[None, None, :, None] + bot * wy[None, None, :, None]
    return cast_like_xla(out, data.dtype)


def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Regression targets and masks of matched boxes against anchors
    (contrib ``box_encode``); corner boxes, samples > 0.5 positive."""
    a_w = anchors[..., 2] - anchors[..., 0]
    a_h = anchors[..., 3] - anchors[..., 1]
    a_x = anchors[..., 0] + 0.5 * a_w
    a_y = anchors[..., 1] + 0.5 * a_h
    idx = matches.long().clamp(min=0)[..., None].expand(*matches.shape, 4)
    ref = torch.gather(refs, 1, idx)
    r_w = ref[..., 2] - ref[..., 0]
    r_h = ref[..., 3] - ref[..., 1]
    r_x = ref[..., 0] + 0.5 * r_w
    r_y = ref[..., 1] + 0.5 * r_h
    valid = (samples > 0.5)[..., None]
    t = torch.stack([(r_x - a_x) / a_w.clamp(min=1e-12),
                     (r_y - a_y) / a_h.clamp(min=1e-12),
                     torch.log(r_w.clamp(min=1e-12) / a_w.clamp(min=1e-12)),
                     torch.log(r_h.clamp(min=1e-12) / a_h.clamp(min=1e-12))],
                    dim=-1)
    t = (t - torch.tensor(means, dtype=t.dtype, device=t.device)) \
        / torch.tensor(stds, dtype=t.dtype, device=t.device)
    masks = torch.where(valid, torch.ones_like(t), torch.zeros_like(t))
    return torch.where(valid, t, torch.zeros_like(t)), masks


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """Boxes from regression deltas against anchors (contrib
    ``box_decode``), in corner format."""
    if format == "corner":
        a_w = anchors[..., 2] - anchors[..., 0]
        a_h = anchors[..., 3] - anchors[..., 1]
        a_x = anchors[..., 0] + 0.5 * a_w
        a_y = anchors[..., 1] + 0.5 * a_h
    else:
        a_x, a_y = anchors[..., 0], anchors[..., 1]
        a_w, a_h = anchors[..., 2], anchors[..., 3]
    dx = data[..., 0] * _f32(std0)
    dy = data[..., 1] * _f32(std1)
    dw = data[..., 2] * _f32(std2)
    dh = data[..., 3] * _f32(std3)
    if clip is not None and clip > 0:
        dw = torch.clamp(dw, max=clip)
        dh = torch.clamp(dh, max=clip)
    cx = dx * a_w + a_x
    cy = dy * a_h + a_y
    w = torch.exp(dw) * a_w
    h = torch.exp(dh) * a_h
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """0-d float32: 1 when ``a`` and ``b`` are close everywhere, else 0."""
    return torch.tensor(float(torch.allclose(a, b, rtol=rtol, atol=atol,
                                             equal_nan=equal_nan)),
                        dtype=torch.float32, device=a.device)


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * (i // repeat)`` shaped like ``data`` (or along
    its ``axis``), in ``data``'s dtype."""
    n = data.numel() if axis is None else data.shape[axis]
    i = torch.arange(n, device=data.device) // repeat
    vals = (_f32(start) + _f32(step) * i.float()).to(data.dtype)
    return vals.reshape(data.shape) if axis is None else vals


def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a·x² + b·x + c."""
    return a * torch.square(data) + b * data + c


def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """Encoder-decoder attention scores: queries (Tq, B, H·dh) against
    the keys of interleaved (Tk, B, H·2·dh) → (B·H, Tq, Tk), queries
    scaled by 1/sqrt(dh) first."""
    tq, b, e = queries.shape
    dh = e // heads
    tk = keys_values.shape[0]
    q = queries.reshape(tq, b, heads, dh).permute(1, 2, 0, 3) \
        .reshape(b * heads, tq, dh)
    kv = keys_values.reshape(tk, b, heads, 2, dh)
    k = kv[:, :, :, 0, :].permute(1, 2, 0, 3).reshape(b * heads, tk, dh)
    q = q / torch.sqrt(torch.tensor(float(dh))).to(q.dtype)
    return torch.einsum("btd,bsd->bts", q, k)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """attention (B·H, Tq, Tk) over the values of interleaved (Tk, B,
    H·2·dh) → (Tq, B, H·dh)."""
    tk, b, e2 = keys_values.shape
    dh = e2 // (heads * 2)
    tq = attention.shape[1]
    kv = keys_values.reshape(tk, b, heads, 2, dh)
    v = kv[:, :, :, 1, :].permute(1, 2, 0, 3).reshape(b * heads, tk, dh)
    out = torch.einsum("bts,bsd->btd", attention, v)
    return out.reshape(b, heads, tq, dh).permute(2, 0, 1, 3).reshape(
        tq, b, heads * dh)


def image_random_resized_crop(x, size=(224, 224), scale=(0.08, 1.0),
                              ratio=(3.0 / 4.0, 4.0 / 3.0), seed=None):
    """Crop a window of random area and aspect (10 tries, else the whole
    image), then resize to ``size`` (bilinear, no antialias): the JAX
    op's draws from ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    H, W = x.shape[-3], x.shape[-2]
    area = float(H * W)
    size = (size, size) if isinstance(size, int) else tuple(size)
    crop = x
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = rng.uniform(*ratio)
        w = int(round((target * ar) ** 0.5))
        h = int(round((target / ar) ** 0.5))
        if w <= W and h <= H:
            x0 = rng.randint(0, W - w + 1)
            y0 = rng.randint(0, H - h + 1)
            crop = x[..., y0:y0 + h, x0:x0 + w, :]
            break
    return image_resize(crop, size=size)
