"""Shared helpers (counterpart of ``incubator_mxnet_tpu/base.py``)."""
from __future__ import annotations

import os

__all__ = ["get_env", "resolve_chunk_steps"]


def get_env(name: str, default, dtype=str):
    """dmlc::GetEnv equivalent: typed environment variable lookup.

    Honours the same names as the JAX package, under both the
    ``MXNET_*`` and ``MXTPU_*`` prefixes, so one deployment's settings
    drive either package.
    """
    for candidate in (name, name.replace("MXNET_", "MXTPU_")):
        val = os.environ.get(candidate)
        if val is not None:
            if dtype is bool:
                return val not in ("0", "false", "False", "")
            return dtype(val)
    return default


def resolve_chunk_steps(chunk_steps=None):
    """K, the steps of the chunked training loop (``fuse_loop.py``): an
    explicit value wins, else ``MXNET_TRAIN_CHUNK_STEPS`` (default 1,
    the per-step fused path).  Below 1 raises ``ValueError``."""
    k = int(chunk_steps if chunk_steps is not None
            else get_env("MXNET_TRAIN_CHUNK_STEPS", 1, int))
    if k < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {k}")
    return k
