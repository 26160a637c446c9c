"""The port's top-level namespaces: after a bare ``import
incubator_mxnet_tpu_torch as mx`` every ported module is bound under the
JAX package's names and aliases, with no ``jax`` module loaded and no
kernel built; ``gluon`` binds ``model_zoo``, ``ParameterDict``,
``Constant``, ``split_and_load``, ``data.vision`` and ``contrib``;
``mx.contrib.quantization`` and ``mx.gluon.contrib.fuse_conv_bn`` hold
the JAX package's names;
``mx.random.seed`` seeds the host streams the image code draws from as
``random.Random`` and ``numpy.random.RandomState`` would be seeded.
"""
import os
import random as pyrandom
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOP = ["nd", "ndarray", "autograd", "random", "initializer", "init",
       "optimizer", "lr_scheduler", "gluon", "io", "recordio", "image", "amp",
       "metric", "rtc", "deploy", "serving", "checkpoint", "models", "cpu",
       "gpu", "Context", "MXNetError", "contrib"]
GLUON = ["model_zoo", "ParameterDict", "Constant", "split_and_load", "data",
         "nn", "rnn", "loss", "metric", "utils", "Trainer", "HybridBlock",
         "Block", "contrib"]


def test_bare_import_binds_every_name():
    code = (
        "import sys\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        f"missing = [n for n in {TOP!r} if not hasattr(mx, n)]\n"
        f"missing += ['gluon.' + n for n in {GLUON!r} "
        "if not hasattr(mx.gluon, n)]\n"
        "missing += [n for n in ('vision',) if not hasattr(mx.gluon.data, n)]\n"
        "missing += [n for n in ('transforms', 'MNIST', 'ImageFolderDataset')"
        " if not hasattr(mx.gluon.data.vision, n)]\n"
        "missing += [n for n in ('ImageRecordIter', 'NDArrayIter', "
        "'DataBatch', 'DataDesc', 'LibSVMIter') if not hasattr(mx.io, n)]\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'incubator_mxnet_tpu' or "
        "m.startswith('incubator_mxnet_tpu.'))\n"
        "assert not bad, bad\n"
        "from incubator_mxnet_tpu_torch.ops import _build\n"
        "assert not _build._libs and not _build._launchers\n"
        "assert mx.nd is mx.ndarray and mx.init is mx.initializer\n"
        "assert mx.metric is mx.gluon.metric\n"
        "assert mx.lr_scheduler is mx.optimizer.lr_scheduler\n"
        "assert mx.gluon.Block is mx.gluon.HybridBlock\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_contrib_namespaces_hold_the_jax_names():
    import incubator_mxnet_tpu_torch as mx
    for name in ("quantize_net", "CalibrationCollector",
                 "optimal_threshold_kl", "QuantizedDense", "QuantizedConv2D"):
        assert hasattr(mx.contrib.quantization, name), name
    assert mx.gluon.contrib.fuse_conv_bn is \
        mx.gluon.contrib.fuse_bn.fuse_conv_bn
    assert mx.gluon.nn.Identity()(torch.ones(2)).tolist() == [1.0, 1.0]
    assert mx.nd.quantize is mx.nd._contrib_quantize_v2


def test_unported_names_stay_unbound():
    import incubator_mxnet_tpu_torch as mx
    for name in ("sym", "symbol", "mod", "module", "kv", "kvstore", "np",
                 "npx", "parallel"):
        assert not hasattr(mx, name), name


def test_split_and_load():
    import incubator_mxnet_tpu_torch as mx
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    (out,) = mx.gluon.split_and_load(x, [mx.cpu()])
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), x)
    (out,) = mx.gluon.utils.split_and_load(torch.tensor(x), ["cpu"])
    assert np.array_equal(out.numpy(), x)
    with pytest.raises(NotImplementedError, match="item 11"):
        mx.gluon.split_and_load(x, [mx.cpu(), mx.cpu()])


def test_random_seed_seeds_the_host_streams():
    import incubator_mxnet_tpu_torch as mx
    mx.random.seed(123)
    a = [mx.random.py_rng.randint(0, 99) for _ in range(5)]
    b = mx.random.np_rng.uniform(size=5)
    ref_py, ref_np = pyrandom.Random(123), np.random.RandomState(123)
    assert a == [ref_py.randint(0, 99) for _ in range(5)]
    assert np.array_equal(b, ref_np.uniform(size=5))
    mx.random.seed(0)
