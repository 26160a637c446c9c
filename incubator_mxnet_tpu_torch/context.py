"""Device context (counterpart of ``incubator_mxnet_tpu/context.py``).

A :class:`Context` names a logical device and maps to a
``torch.device``.  Unlike the JAX package, nothing falls back: the
default device is ``cuda:0``, and asking for a CUDA device where there
is none raises :class:`~.error.DeviceUnavailableError`.
"""
from __future__ import annotations

import torch

from .error import DeviceUnavailableError

__all__ = ["Context", "cpu", "gpu", "default_device", "resolve_device"]


class Context:
    """A logical device: ``Context('gpu', 0)`` is ``cuda:0``."""

    _torch_type = {"cpu": "cpu", "gpu": "cuda"}

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in self._torch_type:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def default_device() -> torch.device:
    """``cuda:0``; raises when no CUDA device is present."""
    return resolve_device("cuda:0")


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; a :class:`Context`, string or
    ``torch.device`` → that device.  A CUDA device that does not exist
    raises; the CPU is used only when asked for by name."""
    if device is None:
        device = "cuda:0"
    if isinstance(device, Context):
        device = device.torch_device
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"{device} requested but no CUDA device is present; pass "
                "device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        elif device.index >= torch.cuda.device_count():
            raise DeviceUnavailableError(
                f"{device} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) present")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
