"""Runnable examples of the port (``python -m
incubator_mxnet_tpu_torch.examples.<name>``)."""
