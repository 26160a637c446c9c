"""Carry weights from the JAX package to the port.

The JAX package names parameters by structure
(``encoder.layer0.attention.qkv.weight``) and the port's modules have
the same attribute paths, so names map one for one and layouts agree
(``Dense`` weights are ``(units, in_units)`` in both).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(named, module):
    """Load ``named`` — ``{name: numpy array}``, as the JAX model's
    ``{k: p.data().asnumpy() for k, p in collect_params().items()}``
    gives — into ``module``, and return the state dict that was loaded.

    Every name of the module must be present with its shape, and no
    other name may be: anything missing, extra or misshapen raises
    ``ValueError`` before the module is touched.  Values are converted
    to each parameter's dtype and device."""
    own = module.state_dict()
    missing = sorted(set(own) - set(named))
    extra = sorted(set(named) - set(own))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"extra {extra}")
    state = {}
    for name, ref in own.items():
        arr = np.asarray(named[name])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(ref.shape)}")
        state[name] = torch.tensor(arr, dtype=ref.dtype, device=ref.device)
    module.load_state_dict(state, strict=True)
    return state
