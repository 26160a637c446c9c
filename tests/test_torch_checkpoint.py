"""The port's ``checkpoint.AsyncCheckpointManager`` against the JAX
package's, on the CPU.

* Round trips in float32, bfloat16, int32, float64 and 0-d values: the
  restored tensors equal the saved ones bit for bit, in their dtypes.
* Files both ways: the port restores a step the JAX package wrote, and
  the JAX package restores a step the port wrote, bit for bit (bfloat16
  compared through its 16-bit pattern), with the same file names and
  index.
* A snapshot is immune to in-place updates made after ``save`` returns
  (the fused step updates its state in place).
* Pruning keeps ``keep`` steps; a failed write publishes nothing and is
  raised as ``CheckpointWriteError`` at the next ``wait``/``save``; a
  stale staging directory is removed; a missing step raises
  ``FileNotFoundError``; a CRC mismatch falls back to the newest step
  that loads, while an explicit step stays strict.
* A chunked fused run saved at each chunk boundary (``on_chunk``) and
  resumed from the first chunk's checkpoint equals the uninterrupted run
  bit for bit.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.checkpoint import (
    AsyncCheckpointManager as JaxManager)
from incubator_mxnet_tpu.error import CheckpointCorruptError as JaxCorrupt

from incubator_mxnet_tpu_torch.checkpoint import AsyncCheckpointManager
from incubator_mxnet_tpu_torch.error import (CheckpointCorruptError,
                                             CheckpointWriteError)
from incubator_mxnet_tpu_torch.fuse import make_fused_train_step
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params/w": torch.randn(4, 3, generator=g),
            "params/w_bf16": torch.randn(5, 2, generator=g).to(
                torch.bfloat16),
            "opt/t": torch.tensor(7, dtype=torch.int32),
            "aux/ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "aux/f64": torch.randn(3, generator=g, dtype=torch.float64),
            "lr": 0.125}


def _equal(a, b):
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def test_round_trip_in_every_dtype(tmp_path):
    m = AsyncCheckpointManager(tmp_path)
    tree = _tree()
    m.save(3, tree, wait=True)
    assert m.all_steps() == [3] and m.latest_step() == 3
    got = m.restore()
    assert sorted(got) == sorted(tree)
    for k, v in tree.items():
        assert got[k].device.type == "cpu"
        assert _equal(got[k], v), k
    assert got["lr"].dtype == torch.float64 and got["lr"].dim() == 0
    index = json.loads((tmp_path / "step_00000003" / "index.json")
                       .read_text())
    assert index["step"] == 3 and index["nprocs"] == 1
    assert index["params"]["params/w_bf16"]["dtype"] == "bfloat16"
    assert index["params"]["params/w"]["file"] == "params_w.npy"


def test_the_port_restores_a_jax_written_step(tmp_path):
    rng = np.random.RandomState(1)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(5, 2).astype(np.float32)
    JaxManager(tmp_path).save(4, {"w": jnp.asarray(w),
                                  "b": jnp.asarray(b).astype(jnp.bfloat16),
                                  "i": np.arange(3, dtype=np.int32)},
                              wait=True)
    got = AsyncCheckpointManager(tmp_path).restore(4)
    assert torch.equal(got["w"], torch.tensor(w))
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"], torch.tensor(b).to(torch.bfloat16))
    assert torch.equal(got["i"], torch.arange(3, dtype=torch.int32))


def test_jax_restores_a_port_written_step(tmp_path):
    tree = _tree(2)
    AsyncCheckpointManager(tmp_path).save(6, tree, wait=True)
    (tmp_path / "jax").mkdir()
    JaxManager(tmp_path / "jax").save(
        6, {k: (np.asarray(v.float()).astype(jnp.bfloat16)
                if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                else (v.numpy() if isinstance(v, torch.Tensor) else v))
            for k, v in tree.items()}, wait=True)
    ours = sorted(os.listdir(tmp_path / "step_00000006"))
    assert ours == sorted(os.listdir(tmp_path / "jax" / "step_00000006"))
    for name in ours:
        assert (tmp_path / "step_00000006" / name).read_bytes() == (
            tmp_path / "jax" / "step_00000006" / name).read_bytes(), name
    got = JaxManager(tmp_path).restore()
    for k, v in tree.items():
        arr = np.asarray(got[k])
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            assert str(arr.dtype) == "bfloat16"
            np.testing.assert_array_equal(arr.view(np.int16),
                                          v.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(arr, np.asarray(v))


def test_a_snapshot_is_immune_to_later_in_place_updates(tmp_path):
    m = AsyncCheckpointManager(tmp_path)
    w = torch.ones(1000, 100)
    m.save(1, {"w": w})
    w.mul_(3.0)                      # the fused step updates in place
    m.wait()
    assert torch.equal(m.restore(1)["w"], torch.ones(1000, 100))


def test_pruning_keeps_the_newest(tmp_path):
    m = AsyncCheckpointManager(tmp_path, keep=2)
    for s in range(5):
        m.save(s, {"w": torch.full((2,), float(s))})
    m.wait()
    assert m.all_steps() == [3, 4]
    assert float(m.restore()["w"][0]) == 4.0


def test_a_failed_write_publishes_nothing_and_is_raised(tmp_path,
                                                       monkeypatch):
    from incubator_mxnet_tpu_torch import checkpoint
    m = AsyncCheckpointManager(tmp_path)
    m.save(1, {"w": torch.zeros(2)}, wait=True)
    real = checkpoint.np.save

    def failing(path, arr):
        if "bad" in str(path):
            raise OSError("disk gone")
        real(path, arr)

    monkeypatch.setattr(checkpoint.np, "save", failing)
    m.save(2, {"w": torch.zeros(2), "bad": torch.ones(2)})
    with pytest.raises(CheckpointWriteError, match="disk gone") as err:
        m.wait()
    assert isinstance(err.value, RuntimeError)
    assert m.all_steps() == [1]
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    m.save(3, {"bad": torch.ones(2)})
    with pytest.raises(CheckpointWriteError):     # kept: the next save
        m.save(4, {"w": torch.zeros(2)})
    monkeypatch.setattr(checkpoint.np, "save", real)
    m.save(4, {"w": torch.zeros(2)}, wait=True)
    assert m.all_steps() == [1, 4]


def test_a_stale_staging_dir_is_removed(tmp_path):
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir()
    (stale / "w.npy").write_bytes(b"half")
    old = time.time() - 3600
    os.utime(stale / "w.npy", (old, old))
    os.utime(stale, (old, old))
    fresh = tmp_path / "step_00000010.tmp"
    fresh.mkdir()
    m = AsyncCheckpointManager(tmp_path)
    assert not stale.exists() and fresh.exists()
    assert m.all_steps() == [] and m.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        m.restore()
    with pytest.raises(FileNotFoundError, match="step 3"):
        m.restore(3)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_crc_mismatch_falls_back_newest_first(tmp_path, package):
    m = AsyncCheckpointManager(tmp_path)
    for s in (1, 2):
        m.save(s, {"w": torch.full((64,), float(s))}, wait=True)
    f = tmp_path / "step_00000002" / "w.npy"
    raw = bytearray(f.read_bytes())
    raw[-3] ^= 0x10                  # one payload bit
    f.write_bytes(bytes(raw))
    if package == "port":
        assert float(m.restore()["w"][0]) == 1.0
        with pytest.raises(CheckpointCorruptError, match="CRC mismatch"):
            m.restore(2)
    else:
        jm = JaxManager(tmp_path)
        assert float(jm.restore()["w"][0]) == 1.0
        with pytest.raises(JaxCorrupt, match="CRC mismatch"):
            jm.restore(2)
    f1 = tmp_path / "step_00000001" / "index.json"
    f1.write_text("{torn")
    with pytest.raises(CheckpointCorruptError, match="no valid checkpoint"):
        m.restore()


def _dense_step(chunk_steps):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.Dense(5, in_units=16))
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    return make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9},
                                 device="cpu", chunk_steps=chunk_steps)


def test_a_chunked_run_resumes_from_its_checkpoint_bit_for_bit(tmp_path):
    rng = np.random.RandomState(1)
    batches = [(torch.tensor(rng.rand(4, 8).astype("f")),
                torch.tensor(rng.randint(0, 5, (4,)).astype("i4")))
               for _ in range(9)]
    step = _dense_step(4)
    m = AsyncCheckpointManager(tmp_path, keep=3)
    loop = step.chunked_loop()
    loop.run_epoch(batches, on_chunk=lambda rec: m.save(
        loop.steps_run, step.state_tree()))
    m.wait()
    assert m.all_steps() == [4, 8, 9]
    fresh = _dense_step(4)
    fresh.load_state_tree(m.restore(4))
    fresh.chunked_loop().run_epoch(batches[4:])
    for k, v in step.state_tree().items():
        assert torch.equal(fresh.state_tree()[k], v), k
