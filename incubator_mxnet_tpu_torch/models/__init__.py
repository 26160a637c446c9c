"""Model definitions ported from ``incubator_mxnet_tpu/models``."""
