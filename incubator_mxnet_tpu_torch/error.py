"""Error types (counterpart of ``incubator_mxnet_tpu/error.py``)."""
from __future__ import annotations

__all__ = ["MXNetError", "DeviceUnavailableError", "KernelError",
           "CheckpointCorruptError", "CheckpointWriteError"]


class MXNetError(Exception):
    """Base of the framework's own errors."""


class DeviceUnavailableError(MXNetError, RuntimeError):
    """A CUDA device was asked for (explicitly or by default) and there
    is none.  Raised instead of carrying on quietly on the CPU."""


class KernelError(MXNetError, RuntimeError):
    """A hand-written kernel failed to build or to launch."""


class CheckpointCorruptError(MXNetError):
    """A checkpoint failed its integrity check (a CRC mismatch, a
    truncated file, a missing index): it must not load silently."""


class CheckpointWriteError(MXNetError, RuntimeError):
    """The asynchronous checkpoint writer failed.  The error is kept by
    the manager and raised, as this type and chained to the original,
    at the next ``save()`` or ``wait()``."""
