"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer``)."""
from .optimizer import (SGD, Adam, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "register",
           "create"]
