"""The ``.params`` wire format (counterpart of
``incubator_mxnet_tpu/ndarray/params_io.py``; reference MXNet's
``NDArray::Save/Load``, src/ndarray/ndarray.cc).

Layout (all little-endian):

  file      := uint64 0x112 (list magic) | uint64 reserved=0
             | uint64 n_arrays | ndarray* | uint64 n_keys
             | (uint64 len | utf8 bytes)*
  ndarray   := uint32 magic | payload
    magic 0xF993fac9 (V2) / 0xF993faca (V3, np-shape):
      int32 stype | [sparse: tshape storage_shape] | tshape shape
      | int32 dev_type | int32 dev_id | int32 type_flag
      | [sparse: (int32 aux_type | tshape aux_shape) * nad]
      | raw data | [sparse: raw aux data * nad]
    magic 0xF993fac8 (V1): tshape shape | ctx | int32 type_flag | raw
    other magic = ndim (oldest): uint32 dims[ndim] | ctx | int32 type_flag
      | raw
  tshape    := int32 ndim | int64 dims[ndim]
  ctx       := int32 dev_type | int32 dev_id

Type flags: 0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64, 7 bool,
12 bf16.  Values are read and written as torch tensors on the CPU;
bfloat16 goes through its raw 16-bit pattern, so neither direction
needs numpy to know the type.  The writer gives the JAX package's
bytes: V2 dense records, device type 1 and id 0.  Sparse records
(storage types 1 and 2) raise ``NotImplementedError``: the port has no
sparse arrays yet (ROADMAP §A item 12).
"""
from __future__ import annotations

import struct

import torch

__all__ = ["LIST_MAGIC", "V1_MAGIC", "V2_MAGIC", "V3_MAGIC", "load_bytes",
           "save_bytes"]

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9
V3_MAGIC = 0xF993FACA

_FLAG2DT = {0: torch.float32, 1: torch.float64, 2: torch.float16,
            3: torch.uint8, 4: torch.int32, 5: torch.int8, 6: torch.int64,
            7: torch.bool, 12: torch.bfloat16}
_DT2FLAG = {v: k for k, v in _FLAG2DT.items()}
_SPARSE = "sparse .params records (row_sparse, csr) are not ported yet: " \
    "the port has no sparse arrays (ROADMAP §A item 12)"


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated .params stream")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def tshape(self):
        ndim = self.i32()
        if ndim < 0:  # unknown shape (np semantics)
            return None
        return tuple(struct.unpack(f"<{ndim}q", self.read(8 * ndim)))

    def tensor(self, flag, shape):
        try:
            dtype = _FLAG2DT[flag]
        except KeyError:
            raise ValueError(f"unknown .params type flag {flag}") from None
        n = 1
        for d in shape:
            n *= d
        raw = bytearray(self.read(n * dtype.itemsize))
        if not raw:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def _read_ndarray(r):
    """One record → a CPU tensor, or None for an empty ("none") record."""
    magic = r.u32()
    if magic in (V2_MAGIC, V3_MAGIC):
        stype = r.i32()
        if stype in (1, 2):
            raise NotImplementedError(_SPARSE)
        if stype != 0:
            raise ValueError(f"unknown storage type {stype}")
        shape = r.tshape()
        if shape is None or len(shape) == 0:
            return None
        r.i32(), r.i32()  # context: dev_type, dev_id (placement ignored)
        return r.tensor(r.i32(), shape)
    if magic == V1_MAGIC:
        shape = r.tshape()
    else:  # oldest format: the magic is ndim, then uint32 dims
        shape = tuple(struct.unpack(f"<{magic}I", r.read(4 * magic)))
    if not shape:
        return None
    r.i32(), r.i32()  # context
    return r.tensor(r.i32(), shape)


def load_bytes(buf):
    """Parse a ``.params`` byte string → ``(list of tensors or None, list
    of names)``; the names are empty for an unnamed list."""
    r = _Reader(buf)
    header = r.u64()
    if header != LIST_MAGIC:
        raise ValueError(f"bad .params header {header:#x}")
    r.u64()  # reserved
    arrays = [_read_ndarray(r) for _ in range(r.u64())]
    names = [bytes(r.read(r.u64())).decode() for _ in range(r.u64())]
    return arrays, names


def _write_tshape(out, shape):
    out.append(struct.pack("<i", len(shape)))
    if shape:
        out.append(struct.pack(f"<{len(shape)}q", *shape))


def _raw(t):
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_bytes(items, named=True):
    """``items``: list of ``(name, tensor)``.  Returns the ``.params``
    byte string; ``named=False`` writes an empty key table (an unnamed
    list).  A 0-dim tensor raises: the V2 record reads an empty shape as
    "none" and would drop its value."""
    out = [struct.pack("<QQQ", LIST_MAGIC, 0, len(items))]
    for name, t in items:
        if t.layout != torch.strided:
            raise NotImplementedError(_SPARSE)
        if t.dim() == 0:
            raise ValueError(f"{name or 'array'}: a 0-dim tensor cannot be "
                             "written to a .params file (an empty shape "
                             "reads back as none); reshape it to (1,)")
        try:
            flag = _DT2FLAG[t.dtype]
        except KeyError:
            raise TypeError(f"{name or 'array'}: dtype {t.dtype} has no "
                            ".params type flag") from None
        out.append(struct.pack("<Ii", V2_MAGIC, 0))
        _write_tshape(out, tuple(t.shape))
        out.append(struct.pack("<iii", 1, 0, flag))
        out.append(_raw(t))
    names = [name for name, _ in items] if named else []
    out.append(struct.pack("<Q", len(names)))
    for name in names:
        nb = name.encode()
        out.append(struct.pack("<Q", len(nb)))
        out.append(nb)
    return b"".join(out)
