"""JPEG decode on the card: nvJPEG through ``csrc/jpeg_decode.cu``, and
the host-side parsing both decode paths share.

The JAX package decodes on the host (cv2 or PIL, ``image.py:27-48``;
libjpeg in the native iterator).  On the card a JPEG is decoded by
nvJPEG, the CUDA toolkit's JPEG library, into its planes as coded (Y,
and Cb and Cr at their subsampled sizes) in device memory; the kernel
``ycc_rgb`` of ``csrc/jpeg_decode.cu`` then makes interleaved RGB uint8
from them as libjpeg does (its "fancy" chroma upsampling and its
fixed-point colour conversion), so that only the inverse DCT differs
from libjpeg's.  nvJPEG's own RGB output upsamples chroma another way,
3.7 grey levels from libjpeg's on average on a 4:2:0 fixture.  A grey
JPEG comes out as three equal channels, as ``_decode_bytes`` converts
it.  Chroma layouts 4:4:4, 4:2:2, 4:2:0 and 4:4:0 and grey decode;
others raise.  Only baseline and progressive JPEG decode here: PNG and
every other format raise, naming what is missing, and nothing falls
back to the host.

:func:`jpeg_size` reads an image's size from its frame header on the
host (the iterator draws its crops before the decode);
:func:`check_jpeg` refuses what is not a whole JPEG (no start-of-image
marker, or no end-of-image marker after the last scan: a truncated
file) before nvJPEG sees it.  :func:`decode_into` decodes one image
into a given device buffer, :func:`decode` into a new tensor.
``decodes`` counts the images decoded on the card, ``ycc_launches`` the
launches of the colour kernel; :func:`ycc_rgb_reference` is that
kernel's plain version.
"""
from __future__ import annotations

import ctypes
import struct
import threading

import torch

from . import _build
from ..error import KernelError

__all__ = ["jpeg_size", "check_jpeg", "decode_into", "decode", "decodes",
           "is_jpeg", "ycc_rgb", "ycc_rgb_reference", "ycc_launches",
           "MODES"]

#: Images decoded on the card so far, and launches of the colour kernel;
#: :func:`decode_into` and :func:`ycc_rgb` add one each per decode and
#: launch, and nothing else touches them (a caller may reset them to 0).
decodes = 0
ycc_launches = 0

#: The colour kernel's chroma layouts by nvjpegChromaSubsampling_t:
#: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and grey.
MODES = {0: 0, 1: 1, 2: 2, 3: 3, 6: 4}
_CSS_NAMES = {4: "4:1:1", 5: "4:1:0", 7: "4:1:0 (vertical)", -1: "unknown"}

_lock = threading.Lock()
# (device index, host thread) -> (handle, state, lock)
_states: dict[tuple, tuple] = {}
_funcs = {}
_CUDA_BASE = 1000
_STATUS = {1: "NVJPEG_STATUS_NOT_INITIALIZED",
           2: "NVJPEG_STATUS_INVALID_PARAMETER",
           3: "NVJPEG_STATUS_BAD_JPEG",
           4: "NVJPEG_STATUS_JPEG_NOT_SUPPORTED",
           5: "NVJPEG_STATUS_ALLOCATOR_FAILURE",
           6: "NVJPEG_STATUS_EXECUTION_FAILED",
           7: "NVJPEG_STATUS_ARCH_MISMATCH",
           8: "NVJPEG_STATUS_INTERNAL_ERROR",
           9: "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED",
           10: "NVJPEG_STATUS_INCOMPLETE_BITSTREAM"}
# start-of-frame markers: SOF0-SOF15 but DHT (C4), JPG (C8) and DAC (CC)
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_STANDALONE = set(range(0xD0, 0xDA)) | {0x01}


def is_jpeg(buf) -> bool:
    return bytes(buf[:3]) == b"\xff\xd8\xff"


def _format_name(buf):
    head = bytes(buf[:8])
    if head.startswith(b"\x89PNG"):
        return "PNG"
    if head[:2] == b"BM":
        return "BMP"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head[:3] == b"GIF":
        return "GIF"
    return "not JPEG"


def jpeg_size(buf):
    """``(height, width, components)`` from the JPEG's frame header."""
    buf = bytes(buf)
    if not is_jpeg(buf):
        raise ValueError(f"not a JPEG ({_format_name(buf)})")
    i = 2
    while i + 4 <= len(buf):
        if buf[i] != 0xFF:
            raise ValueError("corrupt JPEG: no marker at byte %d" % i)
        marker = buf[i + 1]
        if marker == 0xFF:          # fill byte
            i += 1
            continue
        if marker in _STANDALONE:
            i += 2
            continue
        (length,) = struct.unpack(">H", buf[i + 2:i + 4])
        if marker in _SOF:
            if i + 10 > len(buf):
                break
            _, h, w, comps = struct.unpack(">BHHB", buf[i + 4:i + 10])
            if h == 0 or w == 0:
                raise ValueError(f"JPEG frame of size {h}x{w} not supported")
            return h, w, comps
        if marker == 0xDA:          # a scan before any frame header
            break
        i += 2 + length
    raise ValueError("corrupt JPEG: no frame header")


def check_jpeg(buf):
    """Raise ``ValueError`` unless ``buf`` is a whole JPEG: it starts with
    the start-of-image marker and holds an end-of-image marker after its
    last start-of-scan (entropy-coded data never holds 0xFF 0xD9, so a
    truncated file has none)."""
    buf = bytes(buf)
    if not is_jpeg(buf):
        raise ValueError(f"cannot decode {_format_name(buf)} data on the "
                         "card: nvJPEG decodes JPEG only")
    sos = buf.rfind(b"\xff\xda")
    if sos < 0 or buf.rfind(b"\xff\xd9") < sos:
        raise ValueError("truncated JPEG: no end-of-image marker after its "
                         "last scan")


def _lib():
    """The nvJPEG binding, built and loaded at the first decode."""
    if _funcs:
        return _funcs
    try:
        lib = _build.load("jpeg_decode")
    except KernelError as e:
        raise KernelError(
            "JPEG decode on the card needs nvJPEG (nvjpeg.h and "
            "libnvjpeg.so of the CUDA toolkit): " + str(e)) from e
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    IP = ctypes.POINTER(ctypes.c_int)
    sigs = {"mx_jpeg_create": [I, ctypes.POINTER(P), ctypes.POINTER(P)],
            "mx_jpeg_destroy": [P, P],
            "mx_jpeg_info": [P, ctypes.c_char_p, S, IP, IP, IP, IP],
            "mx_jpeg_decode_planes": [I, P, P, ctypes.c_char_p, S, I, P, I,
                                      P, P, I, P]}
    out = {}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        out[name] = fn
    out["cuda_error"] = lib.mx_cuda_error_string
    _funcs.update(out)
    return _funcs


def _raise(what, status):
    if status >= _CUDA_BASE:
        text = _lib()["cuda_error"](status - _CUDA_BASE).decode()
    else:
        text = _STATUS.get(status, f"nvjpegStatus {status}")
    raise KernelError(f"nvJPEG {what} failed: {text}")


def _state(device):
    """``(handle, state, lock)`` of the calling thread's nvJPEG instance
    on ``device``: each host thread decodes with its own, so several
    threads decode at once."""
    key = (device.index, threading.get_ident())
    with _lock:
        entry = _states.get(key)
        if entry is None:
            fns = _lib()
            handle, state = ctypes.c_void_p(), ctypes.c_void_p()
            st = fns["mx_jpeg_create"](device.index, ctypes.byref(handle),
                                       ctypes.byref(state))
            if st:
                _raise("create", st)
            entry = _states[key] = (handle, state, threading.Lock())
        return entry


def _upsample_reference(p, h, w, mode):
    """libjpeg's fancy upsampling of the coded chroma plane ``p`` (int32
    ch x cw) to h x w (jdsample.c's h2v1, h2v2 and h1v2)."""
    ch, cw = p.shape
    dev = p.device
    if mode == 0:
        return p[:h, :w]
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    if mode == 3:                                    # h1v2
        r, v = ys // 2, ys % 2
        rn = torch.where(v == 1, (r + 1).clamp(max=ch - 1),
                         (r - 1).clamp(min=0))
        s = 3 * p[r][:, :w] + p[rn][:, :w]
        return (s + torch.where(v == 1, 2, 1)[:, None]) >> 2
    c, u = xs // 2, xs % 2
    left, right = (c - 1).clamp(min=0), (c + 1).clamp(max=cw - 1)
    first, last = (c == 0)[None, :], (c == cw - 1)[None, :]
    even = (u == 0)[None, :]
    if mode == 1:                                    # h2v1
        rows = p[:h]
        v0 = rows[:, c]
        a = torch.where(first, v0, (3 * v0 + rows[:, left] + 1) >> 2)
        b = torch.where(last, v0, (3 * v0 + rows[:, right] + 2) >> 2)
        return torch.where(even, a, b)
    r, v = ys // 2, ys % 2                           # h2v2
    rn = torch.where(v == 1, (r + 1).clamp(max=ch - 1), (r - 1).clamp(min=0))
    cs = 3 * p[r] + p[rn]                            # (h, cw) column sums
    cs0 = cs[:, c]
    a = torch.where(first, (cs0 * 4 + 8) >> 4,
                    (3 * cs0 + cs[:, left] + 8) >> 4)
    b = torch.where(last, (cs0 * 4 + 7) >> 4,
                    (3 * cs0 + cs[:, right] + 7) >> 4)
    return torch.where(even, a, b)


def ycc_rgb_reference(y, cb, cr, mode):
    """Plain version of the colour kernel: uint8 planes as coded (``cb``
    and ``cr`` None for grey, mode 4) → uint8 (h, w, 3), by libjpeg's
    fancy upsampling and its fixed-point YCbCr → RGB conversion
    (jdcolor.c), in int32."""
    h, w = y.shape
    lum = y.to(torch.int32)
    if mode == 4:
        return lum.to(torch.uint8)[..., None].expand(h, w, 3).contiguous()
    cbu = _upsample_reference(cb.to(torch.int32), h, w, mode) - 128
    cru = _upsample_reference(cr.to(torch.int32), h, w, mode) - 128
    r = lum + ((91881 * cru + 32768) >> 16)
    g = lum + ((-22554 * cbu + 32768 - 46802 * cru) >> 16)
    b = lum + ((116130 * cbu + 32768) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def _chroma_size(h, w, mode):
    ch = (h + 1) // 2 if mode in (2, 3) else h
    cw = (w + 1) // 2 if mode in (1, 2) else w
    return ch, cw


def ycc_rgb(y, cb, cr, mode, out=None):
    """The colour kernel: planes as coded (uint8 contiguous 2-D tensors,
    ``cb``/``cr`` None for grey) → ``out``, uint8 (h, w, 3) contiguous,
    on the current stream.  On CPU tensors: the plain version."""
    if y.device.type == "cpu":
        res = ycc_rgb_reference(y, cb, cr, mode)
        if out is not None:
            out.view(res.shape).copy_(res)
            return out
        return res
    h, w = y.shape
    ch, cw = (0, 0) if mode == 4 else tuple(cb.shape)
    planes = [y] if mode == 4 else [y, cb, cr]
    if any(p.dtype != torch.uint8 or p.device != y.device
           or not p.is_contiguous() for p in planes) or (
            mode != 4 and (cr.shape != cb.shape
                           or (ch, cw) != _chroma_size(h, w, mode))):
        raise ValueError("ycc_rgb: planes must be contiguous uint8 on one "
                         "device, chroma at its coded size")
    if out is None:
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    if out.numel() != h * w * 3 or not out.is_contiguous() \
            or out.device != y.device:
        raise ValueError(f"ycc_rgb: out must hold {h * w * 3} contiguous "
                         "bytes on the planes' device")
    fn = _build.launcher("jpeg_decode", "mx_jpeg_ycc_rgb", _YCC_ARGS)
    cbp = y.data_ptr() if mode == 4 else cb.data_ptr()
    crp = y.data_ptr() if mode == 4 else cr.data_ptr()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        fn(y.device.index, y.data_ptr(), w, cbp, crp, cw, ch, cw, mode,
           out.data_ptr(), h, w, stream)
    global ycc_launches
    with _lock:
        ycc_launches += 1
    return out


_I, _P = ctypes.c_int, ctypes.c_void_p
# mx_jpeg_ycc_rgb's arguments (csrc/jpeg_decode.cu)
_YCC_ARGS = [_I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P]


def decode_into(buf, out, size=None):
    """Decode the JPEG ``buf`` into ``out``, a contiguous uint8 CUDA
    tensor of h·w·3 bytes (HWC RGB), on the current stream.  ``size``
    is ``(h, w)`` when the caller parsed it already.  The call returns
    once the image is in ``out`` (it synchronises the stream: the
    bitstream and nvJPEG's buffers are then free again)."""
    buf = bytes(buf)
    check_jpeg(buf)
    h, w = size if size is not None else jpeg_size(buf)[:2]
    if out.device.type != "cuda" or out.dtype != torch.uint8 \
            or not out.is_contiguous() or out.numel() != h * w * 3:
        raise ValueError(f"decode_into: out must be a contiguous uint8 CUDA "
                         f"tensor of {h * w * 3} bytes")
    fns = _lib()
    handle, state, lock = _state(out.device)
    comps, css = ctypes.c_int(), ctypes.c_int()
    heights, widths = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    with lock:
        st = fns["mx_jpeg_info"](handle, buf, len(buf), ctypes.byref(comps),
                                 ctypes.byref(css), heights, widths)
        if st:
            _raise("image info", st)
        if (heights[0], widths[0]) != (h, w):
            raise ValueError(f"JPEG size {heights[0]}x{widths[0]} from "
                             f"nvJPEG, {h}x{w} from its frame header")
        if comps.value not in (1, 3):
            raise ValueError(f"JPEG with {comps.value} components not "
                             "supported on the card (grey or YCbCr only)")
        mode = 4 if comps.value == 1 else MODES.get(css.value)
        if mode is None:
            raise NotImplementedError(
                f"JPEG chroma subsampling "
                f"{_CSS_NAMES.get(css.value, css.value)} is not supported on "
                "the card (4:4:4, 4:2:2, 4:2:0, 4:4:0 and grey are)")
        ch, cw = (0, 0) if mode == 4 else _chroma_size(h, w, mode)
        if mode != 4 and (heights[1] < ch or widths[1] < cw):
            raise ValueError(f"nvJPEG chroma plane {heights[1]}x{widths[1]}"
                             f", {ch}x{cw} expected")
        planes = torch.empty(h * w + 2 * ch * cw, dtype=torch.uint8,
                             device=out.device)
        y = planes[:h * w].view(h, w)
        cb = planes[h * w:h * w + ch * cw].view(ch, cw)
        cr = planes[h * w + ch * cw:].view(ch, cw)
        stream = torch.cuda.current_stream(out.device)
        st = fns["mx_jpeg_decode_planes"](
            out.device.index, handle, state, buf, len(buf), int(mode == 4),
            y.data_ptr(), w, cb.data_ptr(), cr.data_ptr(), cw,
            stream.cuda_stream)
        if st:
            _raise("decode", st)
        ycc_rgb(y, None if mode == 4 else cb, None if mode == 4 else cr,
                mode, out)
        stream.synchronize()
    global decodes
    with _lock:
        decodes += 1
    return out


def decode(buf, device):
    """The JPEG ``buf`` decoded on the CUDA ``device`` → uint8 (h, w, 3)."""
    check_jpeg(buf)
    h, w, _ = jpeg_size(buf)
    out = torch.empty(h * w * 3, dtype=torch.uint8, device=device)
    decode_into(buf, out, (h, w))
    return out.view(h, w, 3)
