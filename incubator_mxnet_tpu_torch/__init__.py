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
"""
from .context import Context, cpu, gpu, default_device, resolve_device

__all__ = ["Context", "cpu", "gpu", "default_device", "resolve_device"]
