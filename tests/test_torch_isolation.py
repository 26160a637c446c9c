"""The PyTorch port stands alone and never falls back to the CPU.

* Importing every module of ``incubator_mxnet_tpu_torch`` (and
  ``chip_smoke.py``) loads neither ``jax`` nor ``incubator_mxnet_tpu``.
* No source of the port imports them.
* Without CUDA, the entry points raise unless given ``device="cpu"``.
* ``chip_smoke.py`` fails, and prints no result, without a card or
  without the rest of the repository.
"""
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from incubator_mxnet_tpu_torch import bench, context
from incubator_mxnet_tpu_torch.deploy import load_predictor
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.examples import (train_bert,
                                                train_resnet_fused,
                                                train_transformer_lm)
from incubator_mxnet_tpu_torch.fuse import make_fused_train_step
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                          TransformerLM)
from incubator_mxnet_tpu_torch.serving.model_repository import ModelRepository
from incubator_mxnet_tpu_torch.serving.server import InferenceServer, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "incubator_mxnet_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield SMOKE


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import incubator_mxnet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{SMOKE!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'incubator_mxnet_tpu' "
        "or m.startswith('incubator_mxnet_tpu.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    for mod in ("autograd", "optimizer.optimizer", "gluon.trainer",
                "gluon.loss", "ops.softmax_xent", "examples.train_bert",
                "ops.fused_block", "ops.fused_conv", "gluon.nn.conv_layers",
                "gluon.model_zoo.vision.resnet",
                "examples.train_resnet_fused", "ops._fused_common",
                "amp", "amp.amp", "amp.lists", "fuse", "bench",
                "ops.softmax", "ops.rms_norm", "models.transformer",
                "examples.train_transformer_lm"):
        assert "incubator_mxnet_tpu_torch." + mod in names, mod


_IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        mods = _IMPORT.findall(f.read())
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib"), (path, m)
        assert top != "incubator_mxnet_tpu", (path, m)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    context.default_device,
    lambda: context.resolve_device(context.gpu(0)),
    lambda: load_predictor("no/such/artifact"),
    ModelRepository,
    InferenceServer,
    lambda: main(["--port", "0"]),
    lambda: BERTModel(vocab_size=10, num_layers=1, units=8, hidden_size=8,
                      num_heads=2, max_length=4).initialize(),
    lambda: train_bert.main([]),
    lambda: train_bert.main(["--smoke"]),
    lambda: train_resnet_fused.main([]),
    lambda: train_resnet_fused.main(["--batch", "1", "--steps", "1"]),
    lambda: make_fused_train_step(nn.Dense(2, in_units=2),
                                  SoftmaxCrossEntropyLoss(), "sgd"),
    lambda: bench.main([]),
    lambda: bench.measure(batch=1, image=32, classes=2, steps=1),
    lambda: train_transformer_lm.main([]),
    lambda: train_transformer_lm.main(["--smoke"]),
    lambda: TransformerLM(TransformerConfig(
        vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=8,
        max_len=4)).init(),
])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        entry()


def test_cpu_is_used_only_when_named(no_cuda):
    assert context.resolve_device("cpu") == torch.device("cpu")
    assert context.resolve_device(context.cpu()) == torch.device("cpu")
    assert ModelRepository(device="cpu").device == torch.device("cpu")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    for cwd, script in ((REPO, SMOKE), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            shutil.copy(SMOKE, script)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
