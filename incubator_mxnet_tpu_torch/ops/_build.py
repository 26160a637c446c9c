"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.
A library is built at first use into ``_build/`` beside ``csrc/`` and
named by a hash of every source in ``csrc/`` and of the flags (the
common ones and each source's own, :data:`SOURCE_FLAGS`), so an edited
source or flag builds afresh and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: this module is imported where there is no
``nvcc`` and no card, and only a launch on a CUDA tensor reaches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..error import KernelError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS",
           "nvcc_path", "source_flags", "library_path", "kernel_names",
           "build", "load", "launcher"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: Flags of one source only: ``image_batch`` contracts no ``a*b + c``
#: into an FMA (its values must be the native iterator's, bit for bit);
#: ``jpeg_decode`` links the CUDA toolkit's nvJPEG, found at run time
#: through an rpath to the toolkit's library directory ("{cuda_lib}").
SOURCE_FLAGS = {"image_batch": ("-fmad=false",),
                "jpeg_decode": ("-lnvjpeg", "-Xlinker",
                                "-rpath={cuda_lib}")}

_libs: dict[str, ctypes.CDLL] = {}
_launchers: dict[tuple[str, str], object] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def source_flags(name: str) -> tuple:
    """The extra nvcc flags of ``csrc/<name>.cu``."""
    cuda_lib = os.path.join(os.path.dirname(os.path.dirname(nvcc_path())),
                            "lib64")
    return tuple(f.format(cuda_lib=cuda_lib)
                 for f in SOURCE_FLAGS.get(name, ()))


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCE_FLAGS):
        h.update(" ".join((name,) + source_flags(name)).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        h.update(fname.encode())
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest()}.so")


def kernel_names() -> list[str]:
    """Every kernel source: the stem of each ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build(names) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    each, all started together; returns ``{name: nvcc output}`` for the
    ones compiled now.  Raises :class:`KernelError` if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        dst = library_path(name)
        if os.path.exists(dst):
            continue
        tmp = f"{dst}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu"), *source_flags(name)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            for p, _, _ in jobs.values():
                p.kill()
                p.wait()
            raise KernelError(
                f"cannot run nvcc ({nvcc}) to build {name}: {e}") from e
        jobs[name] = (proc, tmp, dst)
    logs, failed = {}, []
    for name, (proc, tmp, dst) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, dst)  # atomic: a reader never sees half a file
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mx_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launcher(name: str, symbol: str, argtypes):
    """A callable for the C entry ``symbol`` of ``csrc/<name>.cu`` (built
    and loaded at the first call, then kept).  The entry returns a
    ``cudaError_t``; the callable raises :class:`KernelError` with its
    text unless it is 0.  Every pointer and the stream must be declared
    ``ctypes.c_void_p`` in ``argtypes``, or ctypes cuts them to 32
    bits."""
    launch = _launchers.get((name, symbol))
    if launch is not None:
        return launch
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int

    def launch(*args):
        err = fn(*args)
        if err != 0:
            text = lib.mx_cuda_error_string(err).decode()
            raise KernelError(f"{symbol} launch failed: {text} "
                              f"(cudaError {err})")
    return _launchers.setdefault((name, symbol), launch)
