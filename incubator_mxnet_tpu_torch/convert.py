"""Carry weights from the JAX package to the port.

The JAX package names parameters by structure
(``encoder.layer0.attention.qkv.weight``) and the port's modules have
the same attribute paths, so names map one for one and layouts agree
(``Dense`` weights are ``(units, in_units)`` in both).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy", "grads_to_numpy",
           "transformer_params_from_jax", "transformer_params_to_numpy"]


def params_from_jax(named, module):
    """Load ``named`` — ``{name: numpy array}``, as the JAX model's
    ``{k: p.data().asnumpy() for k, p in collect_params().items()}``
    gives — into ``module``, and return the state dict that was loaded.

    Every name of the module must be present with its shape, and no
    other name may be: anything missing, extra or misshapen raises
    ``ValueError`` before the module is touched.  Values are converted
    to each parameter's dtype and device; a bfloat16 array (numpy's
    ``ml_dtypes.bfloat16``, which ``torch.tensor`` refuses) goes through
    float32, which holds every bfloat16 value exactly."""
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
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        state[name] = torch.tensor(arr, dtype=ref.dtype, device=ref.device)
    module.load_state_dict(state, strict=True)
    return state


def params_to_numpy(module):
    """``{name: numpy array}`` of every parameter of ``module``, copied to
    the host — the shape ``params_from_jax`` takes."""
    return {k: p.detach().cpu().numpy().copy()
            for k, p in module.named_parameters()}


def grads_to_numpy(module):
    """``{name: numpy array}`` of every parameter's gradient, copied to
    the host.  A parameter that ``backward()`` did not reach (``.grad``
    is ``None``) reads as zeros, as the JAX package's zero-initialised
    gradient buffer does."""
    return {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.detach().float().cpu().numpy().copy())
            for k, p in module.named_parameters()}


def transformer_params_from_jax(tree, model):
    """Load the JAX ``TransformerLM``'s parameter pytree — ``{"embed",
    "pos_embed", "layers": {"wqkv", ...}, "ln_f"}`` of numpy arrays,
    bfloat16 included — into the port's initialised ``TransformerLM``
    (``models/transformer.py``), and return the state dict that was
    loaded.  ``tree["layers"]["wqkv"]`` is the module's ``layers.wqkv``;
    shapes and layouts are the same, and the checks are
    :func:`params_from_jax`'s."""
    if any(p.is_meta for p in model.parameters()):
        raise ValueError("the model's parameters are empty: call "
                         "init(device=...) first, which places them")
    named = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            named.update({f"{key}.{k}": v for k, v in value.items()})
        else:
            named[key] = value
    return params_from_jax(named, model)


def transformer_params_to_numpy(model):
    """The port's ``TransformerLM`` parameters nested as the JAX pytree is,
    copied to the host as float32 numpy arrays (a bfloat16 value widens
    exactly)."""
    out = {}
    for name, p in model.named_parameters():
        arr = p.detach().float().cpu().numpy().copy()
        head, _, leaf = name.partition(".")
        if leaf:
            out.setdefault(head, {})[leaf] = arr
        else:
            out[name] = arr
    return out
