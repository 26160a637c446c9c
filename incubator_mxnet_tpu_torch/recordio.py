"""RecordIO, the packed binary record format (counterpart of
``incubator_mxnet_tpu/recordio.py``, reference ``python/mxnet/recordio.py``
and dmlc-core's ``recordio.h``).

Each record is ``[magic u32][lrecord u32][data][pad to 4]``, where
lrecord holds cflag (3 bits) | length (29 bits).  A payload that holds
the magic word at a 4-byte boundary is split there, as dmlc-core does,
so a reader can always find the next record.  The files are byte for
byte the JAX package's, ``.idx`` included (``key\\toffset`` lines).

A reader reopens its file in a process other than the one that opened
it (a forked ``DataLoader`` worker must not share a file offset with its
parent), and :meth:`MXIndexedRecordIO.read_idx` seeks and reads under a
lock, so thread workers may share one reader.

``pack_img``/``unpack_img`` carry an encoded image through
``image.py``'s codec (encoding on the host only; decoding on the card
by nvJPEG or on the CPU by cv2/PIL); ``pack_raw``/``unpack_raw`` carry
a decoded HWC uint8 image.  Remote URIs (``s3://``, ``hdfs://``) wait for
``filesystem.py`` (ROADMAP §A item 12).
"""
from __future__ import annotations

import numbers
import os
import struct
import threading

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img",
           "pack_raw", "unpack_raw"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_LEN_MASK = (1 << 29) - 1


def _aligned_magic(buf):
    """The offsets of the magic word in ``buf`` that are multiples of 4,
    where dmlc-core splits a payload."""
    out = []
    i = buf.find(_MAGIC_BYTES)
    while i >= 0:
        if i % 4 == 0:
            out.append(i)
        i = buf.find(_MAGIC_BYTES, i + 1)
    return out


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = str(uri)
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag not in ("r", "w"):
            raise ValueError(f"invalid flag {self.flag}")
        if "://" in self.uri:
            raise NotImplementedError(
                f"{self.uri}: remote URIs need filesystem.py, which is not "
                "ported yet (ROADMAP §A item 12)")
        self.writable = self.flag == "w"
        self.record = open(self.uri, "wb" if self.writable else "rb")
        self.pid = os.getpid()

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def _check_pid(self):
        if self.pid != os.getpid():
            self.reset()

    def write(self, buf: bytes):
        if not self.writable:
            raise IOError(f"{self.uri} is open for reading")
        buf = bytes(buf)
        splits = _aligned_magic(buf)
        if not splits:
            chunks = [(0, buf)]
        else:
            bounds = [0] + splits + [len(buf)]
            chunks = []
            for k in range(len(bounds) - 1):
                lo = bounds[k] + (4 if k > 0 else 0)
                cflag = 1 if k == 0 else (3 if k == len(bounds) - 2 else 2)
                chunks.append((cflag, buf[lo:bounds[k + 1]]))
        for cflag, chunk in chunks:
            self.record.write(struct.pack("<II", _MAGIC,
                                          (cflag << 29) | len(chunk)))
            self.record.write(chunk)
            pad = (4 - len(chunk) % 4) % 4
            if pad:
                self.record.write(b"\x00" * pad)

    def tell(self):
        return self.record.tell()

    def _seek(self, pos):
        self._check_pid()
        self.record.seek(pos)

    def read(self):
        """The next record's payload, or None at the end of the file."""
        if self.writable:
            raise IOError(f"{self.uri} is open for writing")
        self._check_pid()
        parts = []
        multipart = False
        while True:
            header = self.record.read(8)
            if len(header) < 8:
                if multipart:
                    raise IOError(f"truncated multipart record in {self.uri}")
                return None
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise IOError(f"invalid record magic {magic:#x} in {self.uri}")
            cflag, length = (lrec >> 29) & 7, lrec & _LEN_MASK
            if multipart:
                parts.append(_MAGIC_BYTES)
            parts.append(self.record.read(length))
            pad = (4 - length % 4) % 4
            if pad:
                self.record.read(pad)
            if cflag in (0, 3):
                return b"".join(parts)
            multipart = True


class MXIndexedRecordIO(MXRecordIO):
    """Random access through the ``.idx`` file at ``idx_path``: written
    at :meth:`close` by a writer, read at open by a reader."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = str(idx_path)
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self._lock = threading.Lock()
        super().__init__(uri, flag)
        if not self.writable and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        key = key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        d["_lock"] = threading.Lock()
        super().__setstate__(d)

    def close(self):
        if getattr(self, "writable", False) and self.record is not None:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        self._seek(self.idx[idx])

    def read_idx(self, idx):
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


IndexedRecordIO = MXIndexedRecordIO


class IRHeader:
    """An image record's header: ``flag`` (the label's length when the
    label is an array), ``label``, ``id`` and ``id2``."""

    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2


_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """``header`` and the payload ``s`` as one record's bytes; an array
    label follows the header as float32 values."""
    label = header.label
    if isinstance(label, numbers.Number):
        packed = struct.pack(_IR_FORMAT, 0, float(label), header.id,
                             header.id2)
    else:
        label = np.asarray(label, dtype=np.float32)
        packed = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                             header.id2) + label.tobytes()
    return packed + bytes(s)


def unpack(s: bytes):
    """``(IRHeader, payload)`` of a record packed by :func:`pack`."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """``header`` and the HWC uint8 image encoded as ``img_fmt`` (on the
    host: cv2, else PIL; a CUDA tensor raises)."""
    from . import image
    return pack(header, image.imencode(img, img_fmt, quality))


def unpack_img(s, iscolor=1, device=None):
    """``(IRHeader, image)`` of a record packed by :func:`pack_img`: the
    image a uint8 HWC tensor decoded on ``device`` (``cuda:0`` unless
    given)."""
    from . import image
    header, buf = unpack(s)
    return header, image.imdecode(buf, iscolor, device=device)


def pack_raw(header, img):
    """Pack a decoded HWC RGB uint8 image: ``b"MXTR"``, its height and
    width as int32, then its bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"pack_raw needs HWC RGB uint8, got {img.shape}")
    h, w = img.shape[:2]
    return pack(header, b"MXTR" + struct.pack("<ii", h, w) + img.tobytes())


def unpack_raw(s):
    """``(IRHeader, image)`` of a record packed by :func:`pack_raw`: the
    image a read-only (H, W, 3) uint8 view of ``s``."""
    header, buf = unpack(s)
    if buf[:4] != b"MXTR":
        raise ValueError("not a raw MXTR record")
    h, w = struct.unpack("<ii", buf[4:12])
    img = np.frombuffer(buf, np.uint8, count=3 * h * w,
                        offset=12).reshape(h, w, 3)
    return header, img
