"""Error types (counterpart of ``incubator_mxnet_tpu/error.py``)."""
from __future__ import annotations

__all__ = ["MXNetError", "DeviceUnavailableError", "KernelError"]


class MXNetError(Exception):
    """Base of the framework's own errors."""


class DeviceUnavailableError(MXNetError, RuntimeError):
    """A CUDA device was asked for (explicitly or by default) and there
    is none.  Raised instead of carrying on quietly on the CPU."""


class KernelError(MXNetError, RuntimeError):
    """A hand-written kernel failed to build or to launch."""
