"""Optimizers and learning-rate schedules (counterpart of
``incubator_mxnet_tpu/optimizer``)."""
from . import lr_scheduler
from .lr_scheduler import LRScheduler
from .optimizer import (DCASGD, FTML, FTRL, LAMB, LARS, LBSGD, NAG, SGD,
                        SGLD, AdaDelta, AdaGrad, Adam, Adamax, AdamW, Nadam,
                        Optimizer, RMSProp, Signum, Test, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "SGLD", "Signum", "DCASGD", "NAG", "AdaGrad",
           "AdaDelta", "Adam", "AdamW", "Adamax", "Nadam", "FTRL", "FTML",
           "LARS", "LAMB", "RMSProp", "LBSGD", "Test", "Updater",
           "get_updater", "register", "create", "lr_scheduler",
           "LRScheduler"]
