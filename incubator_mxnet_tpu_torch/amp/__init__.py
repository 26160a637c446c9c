"""Automatic mixed precision (counterpart of ``incubator_mxnet_tpu/amp``):
bf16 via ``convert_block`` and a per-op ``CastPolicy``."""
from . import lists
from .amp import (CastPolicy, cast_args, convert_block, current_policy,
                  init, policy_scope)

__all__ = ["CastPolicy", "cast_args", "convert_block", "current_policy",
           "init", "policy_scope", "lists"]
