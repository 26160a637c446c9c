"""PyTorch/CUDA port of the MXNet-capability framework.

A second package beside ``incubator_mxnet_tpu`` (the JAX reference):
the same module and public names, written in PyTorch's idiom
(``nn.Module``s, plain functions on tensors, an explicit ``device``,
``torch.Generator`` for random initialisation).  Kernels that the JAX
package wrote in Pallas for the TPU are hand-written CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use into ``_build/``.

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of falling
back to the CPU.  On a CPU tensor a kernel wrapper runs its plain
PyTorch version, which is what the tests compare against the JAX
package.

The JAX package's module names and aliases are bound here for every
ported module (``mx.nd``, ``mx.gluon``, ``mx.io``, ``mx.image``,
``mx.contrib.quantization``, ...);
names with no port yet (``sym``, ``mod``, ``kv``, ``np``, ``npx``,
``parallel``, ...) stay unbound.  Importing the package builds no
kernel.
"""
from .context import Context, cpu, gpu, default_device, resolve_device
from . import error
from .error import MXNetError
from . import ndarray
from . import ndarray as nd
from . import autograd
from . import random
from . import initializer
from . import initializer as init
from . import optimizer
from .optimizer import lr_scheduler
from . import gluon
from . import recordio
from . import image
from . import io
from . import amp
from .gluon import metric
from . import rtc
from . import checkpoint
from . import deploy
from . import serving
from . import models
from . import contrib

__all__ = ["Context", "cpu", "gpu", "default_device", "resolve_device",
           "MXNetError", "error", "ndarray", "nd", "autograd", "random",
           "initializer", "init", "optimizer", "lr_scheduler", "gluon",
           "recordio", "image", "io", "amp", "metric", "rtc", "checkpoint",
           "deploy", "serving", "models", "contrib"]
