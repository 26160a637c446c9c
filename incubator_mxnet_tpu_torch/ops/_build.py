"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.
A library is built at first use into ``_build/`` beside ``csrc/`` and
named by a hash of every source in ``csrc/`` and of the flags, so an
edited source builds afresh and an unchanged one is reused.
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

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path",
           "library_path", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        h.update(fname.encode())
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest()}.so")


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
               os.path.join(CSRC_DIR, name + ".cu")]
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
            _libs[name] = lib
        return lib
