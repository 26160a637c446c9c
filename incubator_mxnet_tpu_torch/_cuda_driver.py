"""A ctypes binding of NVRTC (``libnvrtc``) and the CUDA driver
(``libcuda``), for :mod:`.rtc`'s run-time-compiled kernels.

NVRTC compiles CUDA C source to a cubin for the card's architecture;
the driver loads the cubin into PyTorch's own (primary) context and
launches its functions on PyTorch's streams.  Nothing here runs at
import: the libraries are opened at the first call, so the module
imports where there is no CUDA at all.

``libnvrtc.so.12`` is looked for in the CUDA toolkit (``$CUDA_HOME``,
then ``/usr/local/cuda``), then in the ``nvidia/cuda_nvrtc`` package
that PyTorch's CUDA 12 wheels install; if none is found,
:class:`~.error.KernelError` lists the paths that were tried.  There
is no other compiler behind it.  Every non-zero ``nvrtcResult`` or
``CUresult`` becomes a :class:`~.error.KernelError` with the error's
name (and, for a compile, NVRTC's whole log).
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import threading

from .error import KernelError

__all__ = ["nvrtc_path", "nvrtc_version", "compile_cubin", "primary_context",
           "load_module", "get_function", "set_max_dynamic_shared",
           "launch", "CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES"]

CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_PS = ctypes.POINTER(ctypes.c_size_t)
_PC = ctypes.POINTER(ctypes.c_char_p)
# (restype, argtypes) of every entry used: each returns a result code,
# an int, except nvrtcGetErrorString
_NVRTC_SIGS = {
    "nvrtcVersion": (_I, [ctypes.POINTER(_I), ctypes.POINTER(_I)]),
    "nvrtcGetErrorString": (ctypes.c_char_p, [_I]),
    "nvrtcCreateProgram": (_I, [_PP, ctypes.c_char_p, ctypes.c_char_p, _I,
                                _PC, _PC]),
    "nvrtcAddNameExpression": (_I, [_P, ctypes.c_char_p]),
    "nvrtcCompileProgram": (_I, [_P, _I, _PC]),
    "nvrtcGetProgramLogSize": (_I, [_P, _PS]),
    "nvrtcGetProgramLog": (_I, [_P, ctypes.c_char_p]),
    "nvrtcGetCUBINSize": (_I, [_P, _PS]),
    "nvrtcGetCUBIN": (_I, [_P, ctypes.c_char_p]),
    "nvrtcGetLoweredName": (_I, [_P, ctypes.c_char_p, _PC]),
    "nvrtcDestroyProgram": (_I, [_PP]),
}
_CUDA_SIGS = {
    "cuInit": (_I, [ctypes.c_uint]),
    "cuGetErrorName": (_I, [_I, _PC]),
    "cuDeviceGet": (_I, [ctypes.POINTER(_I), _I]),
    "cuDevicePrimaryCtxRetain": (_I, [_PP, _I]),
    "cuCtxGetCurrent": (_I, [_PP]),
    "cuCtxSetCurrent": (_I, [_P]),
    "cuModuleLoadData": (_I, [_PP, ctypes.c_char_p]),
    "cuModuleGetFunction": (_I, [_PP, _P, ctypes.c_char_p]),
    "cuFuncSetAttribute": (_I, [_P, _I, _I]),
    "cuLaunchKernel": (_I, [_P] + [ctypes.c_uint] * 7 + [_P, _P, _P]),
}
_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_nvrtc_path: str | None = None
_contexts: dict[int, int] = {}


def _declare(lib, sigs):
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _nvrtc_candidates() -> list[str]:
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(os.path.join(os.environ["CUDA_HOME"], "lib64"))
    dirs.append("/usr/local/cuda/lib64")
    spec = importlib.util.find_spec("nvidia")
    for root in (spec.submodule_search_locations or []) if spec else []:
        dirs.append(os.path.join(root, "cuda_nvrtc", "lib"))
    return [os.path.join(d, "libnvrtc.so.12") for d in dirs]


def _nvrtc() -> ctypes.CDLL:
    global _nvrtc_path
    with _lock:
        if "nvrtc" in _libs:
            return _libs["nvrtc"]
        tried = _nvrtc_candidates()
        for path in tried:
            if os.path.exists(path):
                lib = ctypes.CDLL(path)
                break
        else:
            raise KernelError("libnvrtc.so.12 not found; tried "
                              + ", ".join(tried))
        _nvrtc_path = path
        _libs["nvrtc"] = _declare(lib, _NVRTC_SIGS)
        return lib


def _cuda() -> ctypes.CDLL:
    with _lock:
        if "cuda" in _libs:
            return _libs["cuda"]
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise KernelError(f"the CUDA driver (libcuda.so.1) cannot be "
                              f"loaded: {e}") from None
        _declare(lib, _CUDA_SIGS)
        _check_cu(lib, lib.cuInit(0), "cuInit")
        _libs["cuda"] = lib
        return lib


def _check_cu(lib, result, what):
    if result != 0:
        name = ctypes.c_char_p()
        lib.cuGetErrorName(result, ctypes.byref(name))
        raise KernelError(f"{what}: {(name.value or b'?').decode()} "
                          f"(CUresult {result})")


def _check_nvrtc(lib, result, what, log=""):
    if result != 0:
        msg = f"{what}: {lib.nvrtcGetErrorString(result).decode()}"
        raise KernelError(msg + (f"\n{log}" if log else ""))


def nvrtc_path() -> str:
    """The ``libnvrtc`` that was loaded (loading it if need be)."""
    _nvrtc()
    return _nvrtc_path


def nvrtc_version() -> tuple[int, int]:
    lib = _nvrtc()
    major, minor = _I(), _I()
    _check_nvrtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _program_log(lib, prog) -> str:
    size = ctypes.c_size_t()
    if lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)) != 0:
        return ""
    buf = ctypes.create_string_buffer(size.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace")


def compile_cubin(source: str, options, name_expressions=(),
                  name="source.cu") -> tuple[bytes, dict[str, str], str]:
    """Compile ``source`` with NVRTC → ``(cubin, {expression: lowered
    name}, log)``.  Each of ``name_expressions`` (``"axpy<float>"``) is
    added before the compile, which instantiates it, and resolved to
    its mangled name after.  ``options`` must name a real architecture
    (``--gpu-architecture=sm_90a``) for NVRTC to give a cubin.  A
    failed compile raises :class:`KernelError` with the whole log."""
    lib = _nvrtc()
    prog = _P()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(
                prog, expr.encode()), f"nvrtcAddNameExpression({expr!r})")
        opts = [o.encode() for o in options]
        argv = (ctypes.c_char_p * max(len(opts), 1))(*opts)
        result = lib.nvrtcCompileProgram(prog, len(opts), argv)
        log = _program_log(lib, prog)
        _check_nvrtc(lib, result, "nvrtcCompileProgram", log)
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        if size.value == 0:
            raise KernelError("NVRTC gave no cubin: the options must name a "
                              f"real architecture (sm_XX), got {options}")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, expr.encode(), ctypes.byref(out)),
                f"nvrtcGetLoweredName({expr!r})")
            lowered[expr] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def primary_context(device_index: int) -> int:
    """Make the device's primary context — the one PyTorch's runtime
    uses — current on the calling thread, and return it."""
    lib = _cuda()
    with _lock:
        ctx = _contexts.get(device_index)
        if ctx is None:
            dev = _I()
            _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), device_index),
                      "cuDeviceGet")
            handle = _P()
            _check_cu(lib, lib.cuDevicePrimaryCtxRetain(
                ctypes.byref(handle), dev.value), "cuDevicePrimaryCtxRetain")
            ctx = _contexts[device_index] = handle.value
    current = _P()
    _check_cu(lib, lib.cuCtxGetCurrent(ctypes.byref(current)),
              "cuCtxGetCurrent")
    if current.value != ctx:
        _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return ctx


def load_module(cubin: bytes, device_index: int) -> int:
    """Load a cubin into the device's primary context → ``CUmodule``."""
    lib = _cuda()
    primary_context(device_index)
    module = _P()
    _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(module), cubin),
              "cuModuleLoadData")
    return module.value


def get_function(module: int, name: str) -> int:
    """The ``CUfunction`` of ``name`` (its mangled name, or the plain
    one of an ``extern "C"`` kernel) in ``module``."""
    lib = _cuda()
    fn = _P()
    result = lib.cuModuleGetFunction(ctypes.byref(fn), module, name.encode())
    if result != 0:
        try:
            _check_cu(lib, result, f"cuModuleGetFunction({name!r})")
        except KernelError as e:
            raise KernelError(
                f"{e}: a kernel is found by name only if it is declared "
                "extern \"C\" or listed in the module's exports (e.g. "
                "exports=[\"axpy<float>\"])") from None
    return fn.value


def set_max_dynamic_shared(fn: int, nbytes: int):
    """Let ``fn`` take ``nbytes`` of dynamic shared memory (needed above
    48 KiB; Hopper allows up to 227 KiB a block)."""
    lib = _cuda()
    _check_cu(lib, lib.cuFuncSetAttribute(
        fn, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
        "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")


def launch(fn: int, grid, block, shared_mem: int, stream: int, params):
    """``cuLaunchKernel`` on ``stream``.  ``params`` is the ``void*[]``
    of argument addresses; the caller keeps it, and every value it
    points to, alive until this returns."""
    lib = _cuda()
    _check_cu(lib, lib.cuLaunchKernel(
        fn, *grid, *block, shared_mem, stream, params, None),
        "cuLaunchKernel")
