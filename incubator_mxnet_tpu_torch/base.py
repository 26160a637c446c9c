"""Shared helpers (counterpart of ``incubator_mxnet_tpu/base.py``)."""
from __future__ import annotations

import os

__all__ = ["get_env"]


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
