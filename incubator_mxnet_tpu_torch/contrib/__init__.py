"""``mx.contrib`` (counterpart of ``incubator_mxnet_tpu/contrib``): int8
post-training quantization.  The JAX package's ``contrib.onnx`` is not
ported."""
from . import quantization

__all__ = ["quantization"]
