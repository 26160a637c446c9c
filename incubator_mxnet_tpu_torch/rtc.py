"""Kernels compiled at run time (counterpart of
``incubator_mxnet_tpu/rtc.py``; reference MXNet's ``python/mxnet/rtc.py``).

On the card, :class:`CudaModule` does what reference MXNet's does: it
takes CUDA C source, compiles it with NVRTC when it is constructed, and
launches its kernels on tensors.  The JAX package's counterpart of this
path is a Pallas kernel that Mosaic compiles (kernel row 17 of PERF.md
§6); here the user's own CUDA C is the kernel, compiled to a cubin for
the card's architecture (``sm_90a`` on an H100) and launched with
``cuLaunchKernel`` on PyTorch's current stream, so torch operations
before and after it are ordered without a synchronise::

    from incubator_mxnet_tpu_torch import context, rtc

    mod = rtc.CudaModule(r'''
    extern "C" __global__ void saxpy(const float *x, float *y, float a,
                                     int n) {
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
             i += gridDim.x * blockDim.x)
            y[i] = a * x[i] + y[i];
    }''')
    k = mod.get_kernel("saxpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 3.0, x.numel()], context.gpu(0), (264,), (256,))

Arbitrary CUDA C has no plain version on the CPU, so without a CUDA
device :class:`CudaModule` raises
:class:`~.error.DeviceUnavailableError`; there is no other compiler
behind NVRTC.

:class:`PallasModule` runs a Python kernel written over *refs*, as the
JAX package's does: one call for each point of the grid, in row-major
order, on the CPU or on the card.  A kernel reads its grid position
with :func:`program_id` and :func:`num_programs`, the counterparts of
``pl.program_id`` and ``pl.num_programs``::

    def saxpy(x_ref, y_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha + y_ref[...]

    mod = rtc.PallasModule(saxpy, num_inputs=2, static_args=("alpha",))
    out = mod.get_kernel("saxpy", alpha=3.0).launch([x, y])
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import os
import re
import threading
import time

import numpy as np
import torch

from . import _cuda_driver as drv
from .context import Context, resolve_device
from .error import DeviceUnavailableError

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "program_id",
           "num_programs", "parse_signature", "launches"]

#: Launches of user CUDA kernels so far: :meth:`CudaKernel.launch` adds
#: one per ``cuLaunchKernel`` and nothing else touches it (a caller may
#: reset it to 0).
launches = 0

# C type of a kernel parameter → (numpy type of a scalar, torch dtype of
# a pointer's tensor); reference rtc.py's _DTYPE_CPP_TO_NP
_TYPES = {
    "float": (np.float32, torch.float32),
    "double": (np.float64, torch.float64),
    "__half": (np.float16, torch.float16),
    "uint8_t": (np.uint8, torch.uint8),
    "int": (np.int32, torch.int32),
    "int32_t": (np.int32, torch.int32),
    "int8_t": (np.int8, torch.int8),
    "char": (np.int8, torch.int8),
    "int64_t": (np.int64, torch.int64),
}
_PARAM = re.compile(r"^(const\s+)?(\w+)\s*(\*)?\s*(?:const\s+)?(\w+)?$")
_DEFAULT_SHARED = 48 * 1024

_count_lock = threading.Lock()
_compile_lock = threading.Lock()
_cubins: dict[tuple, tuple[bytes, dict[str, str], float]] = {}


def parse_signature(signature: str):
    """``"const float *x, float *y, float alpha, int n"`` → one
    ``(name, c_type, is_pointer, is_const)`` for each parameter.  An
    unknown type, or a parameter not of the form ``[const] type [*]
    [name]``, raises ``ValueError`` that names it."""
    out = []
    for i, raw in enumerate(signature.split(",")):
        arg = " ".join(raw.split())
        m = _PARAM.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError(f"parameter {i} {arg!r} of {signature!r} is not "
                             "of the form '[const] type [*] [name]'")
        const, ctype, star, name = m.groups()
        if ctype not in _TYPES:
            raise ValueError(f"parameter {i} {arg!r}: unknown type {ctype!r} "
                             f"(known: {', '.join(_TYPES)})")
        out.append((name or f"arg{i}", ctype, bool(star), bool(const)))
    return out


def _dims(dims, what):
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, int) and d >= 1 for d in dims):
        raise ValueError(f"{what} must be 1 to 3 positive ints, got {dims}")
    return dims + (1,) * (3 - len(dims))


def _cuda_device(ctx) -> torch.device:
    if isinstance(ctx, Context) and ctx.device_type != "gpu":
        raise ValueError(f"a CUDA kernel launches on a GPU context, got "
                         f"{ctx}")
    device = resolve_device(ctx)
    if device.type != "cuda":
        raise ValueError(f"a CUDA kernel launches on a CUDA device, got "
                         f"{device}")
    return device


class CudaKernel:
    """One kernel of a :class:`CudaModule`, bound to its C signature."""

    def __init__(self, module, name, symbol, params):
        self._module = module
        self.name = name
        self._symbol = symbol
        self._params = params
        self._functions: dict[int, int] = {}
        self._shared_set: dict[int, int] = {}

    def _function(self, index):
        fn = self._functions.get(index)
        if fn is None:
            fn = drv.get_function(self._module._cu_module(index),
                                  self._symbol)
            self._functions[index] = fn
        return fn

    def _pack(self, args, device):
        if len(args) != len(self._params):
            raise ValueError(f"kernel {self.name} takes "
                             f"{len(self._params)} arguments, got "
                             f"{len(args)}")
        values = []
        for arg, (pname, ctype, pointer, _) in zip(args, self._params):
            scalar_type, dtype = _TYPES[ctype]
            if pointer:
                if not isinstance(arg, torch.Tensor):
                    raise TypeError(f"{self.name}: {pname} wants a tensor, "
                                    f"got {type(arg).__name__}")
                if arg.device != device:
                    raise ValueError(f"{self.name}: {pname} is on "
                                     f"{arg.device}, the launch on {device}")
                if arg.dtype != dtype:
                    raise TypeError(f"{self.name}: {pname} is {arg.dtype}, "
                                    f"the signature says {ctype} ({dtype})")
                if not arg.is_contiguous():
                    raise ValueError(f"{self.name}: {pname} must be "
                                     "contiguous")
                values.append(np.array(arg.data_ptr(), np.uint64))
            else:
                if isinstance(arg, torch.Tensor) or not isinstance(
                        arg, (int, float, np.number)):
                    raise TypeError(f"{self.name}: {pname} wants a number "
                                    f"({ctype}), got {type(arg).__name__}")
                values.append(np.array(arg, scalar_type))
        return values

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (``context.gpu(i)`` or a CUDA device) over
        ``grid_dims`` blocks of ``block_dims`` threads (1 to 3 ints each,
        padded with 1) with ``shared_mem`` bytes of dynamic shared memory,
        on that device's current stream.  Pointer parameters take
        contiguous CUDA tensors of the signature's dtype on that device;
        scalars take Python numbers.  Writes in place and returns
        ``None``, as the reference does."""
        device = _cuda_device(ctx)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        values = self._pack(args, device)
        fn = self._function(device.index)
        if shared_mem > max(_DEFAULT_SHARED,
                            self._shared_set.get(device.index, 0)):
            drv.set_max_dynamic_shared(fn, shared_mem)
            self._shared_set[device.index] = shared_mem
        # the void*[] of argument addresses; ``values`` keeps every
        # argument alive until cuLaunchKernel has returned
        params = (ctypes.c_void_p * len(values))(
            *[v.ctypes.data for v in values]) if values else None
        drv.primary_context(device.index)
        stream = torch.cuda.current_stream(device).cuda_stream
        drv.launch(fn, grid, block, int(shared_mem), stream, params)
        del values
        global launches
        with _count_lock:
            launches += 1


class PallasModule:
    """A module of Python kernels over refs (the JAX package's
    ``PallasModule``).  ``source`` is a kernel function or ``{name:
    function}``; ``options`` and ``exports`` are taken for signature
    parity and unused.  ``num_inputs`` arguments of a launch are inputs;
    the output has ``out_like``'s shape and dtype (default: the first
    input's), and an argument beyond the inputs is an output written in
    place and returned.  ``out_like`` is a tensor (or anything with a
    torch ``shape`` and ``dtype``).  ``grid`` is the default grid."""

    def __init__(self, source, options=(), exports=(), num_inputs=1,
                 static_args=(), out_like=None, grid=None):
        if callable(source):
            self._kernels = {source.__name__: source}
        elif isinstance(source, dict):
            self._kernels = dict(source)
        else:
            raise TypeError("PallasModule wants a kernel function or {name: "
                            "fn}; CUDA C source goes to CudaModule")
        self._num_inputs = num_inputs
        self._static_names = tuple(static_args)
        self._out_like = out_like
        self._grid = grid

    def get_kernel(self, name, signature=None, **static_kwargs):
        """Bind static parameters → launchable kernel; the C signature is
        accepted and unused (refs carry their types)."""
        if name not in self._kernels:
            raise ValueError(f"no kernel {name!r} in module "
                             f"(have {sorted(self._kernels)})")
        unknown = set(static_kwargs) - set(self._static_names)
        if unknown:
            raise ValueError(f"unknown static args {sorted(unknown)}")
        return _RefKernel(self._kernels[name], name, self._num_inputs,
                          static_kwargs, self._out_like, self._grid)


class CudaModule(PallasModule):
    """CUDA C ``source`` compiled with NVRTC at construction (reference
    ``rtc.CudaModule``).  ``options`` are NVRTC's; unless one names an
    architecture, ``--gpu-architecture=sm_XY`` of the current device is
    added (``sm_90a`` on an H100), so NVRTC gives a cubin and the
    driver compiles nothing, and unless one names an include path, the
    CUDA toolkit's headers are added (for ``cuda_fp16.h``).  Each of
    ``exports`` (``"axpy<float>"``) is instantiated and resolvable by
    :meth:`get_kernel`, for templated or C++-mangled kernels.  Cubins
    are cached in memory by source and options.

    Given a Python kernel instead of source, it is a
    :class:`PallasModule`, as in the JAX package."""

    def __init__(self, source, options=(), exports=(), **kwargs):
        if not isinstance(source, str):
            super().__init__(source, options, exports, **kwargs)
            self._cubin = None
            return
        if kwargs:
            raise TypeError(f"CudaModule of CUDA C takes no "
                            f"{sorted(kwargs)}")
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "CudaModule compiles CUDA C for a CUDA device and none is "
                "present; user CUDA C has no CPU version (PallasModule "
                "kernels run on the CPU)")
        self._options = _with_defaults(tuple(options))
        self._exports = tuple(exports)
        key = (source, self._options, self._exports)
        with _compile_lock:
            if key not in _cubins:
                t0 = time.perf_counter()
                cubin, lowered, _ = drv.compile_cubin(
                    source, self._options, self._exports)
                _cubins[key] = (cubin, lowered, time.perf_counter() - t0)
        self._cubin, self._lowered, self.compile_seconds = _cubins[key]
        self._modules: dict[int, int] = {}

    def _cu_module(self, index):
        with _compile_lock:
            if index not in self._modules:
                self._modules[index] = drv.load_module(self._cubin, index)
            return self._modules[index]

    def get_kernel(self, name, signature=None, **static_kwargs):
        """The kernel ``name`` — an ``extern "C"`` name or one of the
        exports — bound to its C ``signature``."""
        if self._cubin is None:
            return super().get_kernel(name, signature, **static_kwargs)
        if static_kwargs:
            raise TypeError("a CUDA kernel takes no static arguments")
        if signature is None:
            raise TypeError("get_kernel of CUDA C needs the kernel's C "
                            "signature")
        symbol = self._lowered.get(name, name)
        return CudaKernel(self, name, symbol, parse_signature(signature))


def _with_defaults(options):
    opts = options
    if not any(o.startswith(("-arch", "--gpu-architecture")) for o in opts):
        major, minor = torch.cuda.get_device_capability()
        suffix = "a" if major >= 9 else ""
        opts += (f"--gpu-architecture=sm_{major}{minor}{suffix}",)
    if not any(o.startswith(("-I", "--include-path")) for o in opts):
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        include = os.path.join(home, "include")
        if os.path.exists(os.path.join(include, "cuda_fp16.h")):
            opts += (f"--include-path={include}",)
    if not any(o.startswith(("-std", "--std")) for o in opts):
        opts += ("--std=c++17",)
    return opts


# -- PallasModule's refs and grid ------------------------------------------

_grid_state = threading.local()


def _running(attr):
    value = getattr(_grid_state, attr, None)
    if value is None:
        raise RuntimeError("program_id and num_programs are read inside a "
                           "PallasModule kernel")
    return value


def program_id(axis: int) -> int:
    """The running kernel's index along grid ``axis`` (``pl.program_id``)."""
    return _running("point")[axis]


def num_programs(axis: int) -> int:
    """The grid's size along ``axis`` (``pl.num_programs``)."""
    return _running("grid")[axis]


class _Ref:
    """A tensor seen by a kernel: indexing reads, assigning writes in
    place; ``ref[...]`` is the whole tensor."""

    __slots__ = ("_t",)

    def __init__(self, tensor):
        self._t = tensor

    shape = property(lambda self: tuple(self._t.shape))
    dtype = property(lambda self: self._t.dtype)

    def __getitem__(self, idx):
        return self._t[idx]

    def __setitem__(self, idx, value):
        self._t[idx] = value


class _RefKernel:
    def __init__(self, fn, name, num_inputs, static_kwargs, out_like, grid):
        self._fn = (functools.partial(fn, **static_kwargs) if static_kwargs
                    else fn)
        self.name = name
        self._num_inputs = num_inputs
        self._out_like = out_like
        self._grid = grid

    def launch(self, args, ctx=None, grid_dims=None, block_dims=None,
               shared_mem=0):
        """Run the kernel once per point of ``grid_dims`` (default: the
        module's grid, else one point) on the inputs' device; returns
        the output, or the in-place output argument.  ``block_dims`` and
        ``shared_mem`` are taken for signature parity and unused."""
        inputs = [torch.as_tensor(a) for a in args[:self._num_inputs]]
        device = inputs[0].device
        if ctx is not None and resolve_device(ctx) != device:
            raise ValueError(f"inputs are on {device}, the launch asks for "
                             f"{resolve_device(ctx)}")
        like = self._out_like if self._out_like is not None else inputs[0]
        out = torch.zeros(tuple(like.shape), dtype=like.dtype, device=device)
        grid = tuple(grid_dims or self._grid or (1,))
        refs = [_Ref(t) for t in inputs] + [_Ref(out)]
        saved = getattr(_grid_state, "point", None), getattr(
            _grid_state, "grid", None)
        _grid_state.grid = grid
        try:
            for point in itertools.product(*(range(g) for g in grid)):
                _grid_state.point = point
                self._fn(*refs)
        finally:
            _grid_state.point, _grid_state.grid = saved
        if len(args) > self._num_inputs:
            target = args[self._num_inputs]
            if tuple(target.shape) != tuple(out.shape):
                raise ValueError(f"output argument shape "
                                 f"{tuple(target.shape)} != "
                                 f"{tuple(out.shape)}")
            target.copy_(out)
            return target
        return out
