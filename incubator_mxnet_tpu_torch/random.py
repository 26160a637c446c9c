"""Global random state (counterpart of ``incubator_mxnet_tpu/random.py``).

One ``torch.Generator`` on the CPU and one on each CUDA device that has
drawn, all seeded by :func:`seed`.  ``HybridBlock.initialize`` (whose
initializers draw on the CPU) and ``gluon.data.RandomSampler`` draw from
the CPU generator when they are given none, so ``random.seed(n)`` makes
their draws repeat.  The samplers below draw on the device they are
asked for, from that device's generator.  The streams are PyTorch's
(Philox on the card, Mersenne Twister on the CPU), not the JAX package's
threefry: the same seed gives other numbers by design.
"""
from __future__ import annotations

import threading

import torch

from .context import resolve_device

__all__ = ["seed", "current_seed", "generator", "uniform", "normal",
           "randint"]

_lock = threading.Lock()
_seed = 0
_generators: dict[torch.device, torch.Generator] = {}


def seed(seed_state: int, ctx=None):
    """Reseed the streams (reference ``mx.random.seed``): the CPU
    generator, and the generator of the device ``ctx`` names, or without
    ``ctx`` (or with ``"all"``) every CUDA generator, present and to
    come."""
    global _seed
    seed_state = int(seed_state)
    device = None if ctx is None or ctx == "all" else resolve_device(ctx)
    with _lock:
        _seed = seed_state
        if device is None:
            _generators.clear()
            return
        for dev in {torch.device("cpu"), device}:
            _generators[dev] = _new(dev, seed_state)


def current_seed() -> int:
    return _seed


def _new(device, seed_state):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_state)
    return gen


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device`` (the CPU's by default), created from
    the current seed at its first use."""
    device = resolve_device(device)
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = _generators[device] = _new(device, _seed)
        return gen


def uniform(low=0.0, high=1.0, shape=(), dtype="float32", device=None,
            out=None):
    """U(low, high) samples of ``shape`` on ``device`` (``cuda:0`` unless
    given), or written into ``out``."""
    out = _target(shape, dtype, device, out)
    return out.uniform_(low, high, generator=generator(out.device))


def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", device=None,
           out=None):
    """N(loc, scale²) samples of ``shape`` on ``device``."""
    out = _target(shape, dtype, device, out)
    return out.normal_(loc, scale, generator=generator(out.device))


def randint(low, high=None, shape=(), dtype="int32", device=None, out=None):
    """Integers in [low, high) (``[0, low)`` without ``high``) of ``shape``
    on ``device``."""
    if high is None:
        low, high = 0, low
    out = _target(shape, dtype, device, out)
    return out.random_(low, high, generator=generator(out.device))


def _target(shape, dtype, device, out):
    if out is not None:
        return out
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(dtype))
    return torch.empty(shape, dtype=dtype, device=resolve_device(device))
