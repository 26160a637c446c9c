"""Gluon contrib (counterpart of ``incubator_mxnet_tpu/gluon/contrib``):
``fuse_conv_bn``.  The JAX package's ``cnn``, ``data``, ``estimator``,
``nn`` and ``rnn`` contrib modules are not ported."""
from .fuse_bn import fuse_conv_bn

__all__ = ["fuse_conv_bn"]
