"""What a rematerialized region keeps from its first run for its
recompute (``FusedTrainStep(remat=...)``, ``fuse.py``).

A region's forward runs twice: once in the step's forward, and again
in the backward, where ``torch.utils.checkpoint`` recomputes what the
backward needs.  Three things must not happen a second time:

* random draws (dropout masks, zoneout): the recompute takes the first
  run's draws, so no generator state is read or set (which a CUDA graph
  capture forbids) and the generators advance as a step without remat
  advances them;
* under ``remat="dots"``, the hand-written product kernels (the fused
  1x1 and 3x3 convolutions + BatchNorm): the recompute takes their
  first outputs, as JAX's ``checkpoint_dots`` keeps the products;
* the moving statistics' in-place updates (``register_state_update``):
  the recompute leaves them alone.

:func:`keep` is the one place that decides, by the kind of value.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["Region", "keep", "recomputing"]

_tls = threading.local()


class Region:
    """The values one run of a region keeps for its recompute, in the
    order the run made them."""

    def __init__(self, policy):
        self.policy = policy
        self.kept = []
        self.cursor = 0
        self.recomputing = False

    @contextmanager
    def run(self, recompute):
        """Make this region the thread's active one for a run; the
        recompute replays the kept values from the first."""
        prev = getattr(_tls, "region", None)
        self.recomputing, self.cursor = recompute, 0
        _tls.region = self
        try:
            yield self
        finally:
            _tls.region = prev


def keep(kind, compute):
    """``compute()``, or inside a region's recompute what it returned in
    the first run: ``kind`` ``"random"`` is kept in every region,
    ``"product"`` under the ``"dots"`` policy only."""
    region = getattr(_tls, "region", None)
    if region is None or (kind == "product" and region.policy != "dots"):
        return compute()
    if region.recomputing:
        value = region.kept[region.cursor]
        region.cursor += 1
        return value
    value = compute()
    region.kept.append(value)
    return value


def recomputing():
    """Whether a region's recompute is running on this thread."""
    region = getattr(_tls, "region", None)
    return region is not None and region.recomputing
