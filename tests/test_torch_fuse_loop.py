"""The port's chunked training loop (``fuse_loop.ChunkedTrainLoop``), the
fused step's ``chunk_steps``, ``remat`` and ``donate``, and the device
prefetch ring, against the JAX package and against the port itself, on
the CPU (where the K steps of a chunk run eagerly; the K-step CUDA graph
is held on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

* The JAX suite's Dense(8→16→5) net (``tests/test_fuse_loop.py:27``),
  its weights carried across, 10 batches chunked with K=4 (two chunks
  and a tail of 2) for sgd, nag, adam and adamw: each record's mean loss
  and the final parameters and optimizer state against JAX's
  ``ChunkedTrainLoop``.
* The small fused ``ResNetV1`` of ``tests/test_torch_fuse.py`` trained
  chunked (K=2, 5 batches of 4 64x64 images: two chunks and a tail of
  1) from a ``.rec``
  file the port wrote, read through each package's ``RecordFileDataset``
  and ``DataLoader`` (the port's with process workers), against JAX.
* ``remat="dots"`` and ``"nothing"``: bit for bit the step without
  remat in the port (losses, parameters, moving statistics, momenta,
  with a Dropout block too), and against JAX's remat.
* The port against itself, bit for bit: chunked against sequential (with
  Dropout: both runs start from one seed of the default generator), K=1
  against the per-step path, the tail against the per-step
  continuation.
* Errors matched to JAX's messages, ``resolve_chunk_steps``, the
  ``donate=False`` contract, the ring, the trainer's chunk budget and
  the example's ``--chunk-steps``.

Tolerances, float32, max |port - JAX| over the largest |JAX| value of
each tensor: the Dense net 1e-5 (STEP_TOL: the same formulas, sums in
another order), Adam's and AdamW's 1e-4 (ADAM_TOL: a first Adam step is
lr * g / |g|, which turns a gradient entry near zero, and its rounding,
into a full-size step), as ``tests/test_torch_fuse.py`` states them;
losses 1e-5 relative; the ResNet MODEL_TOL = 2e-4 (the bound
``tests/test_torch_resnet_train.py`` sets above the model's measured
response to rounding).
"""
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import recordio as jax_recordio
from incubator_mxnet_tpu.fuse import make_fused_train_step as jax_fused
from incubator_mxnet_tpu.gluon import nn as jax_nn
from incubator_mxnet_tpu.gluon.data.dataloader import (
    DevicePrefetchRing as JaxRing)
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet

from incubator_mxnet_tpu_torch import base, recordio
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.examples import train_resnet_fused
from incubator_mxnet_tpu_torch.fuse import make_fused_train_step
from incubator_mxnet_tpu_torch.fuse_loop import ChunkedTrainLoop
from incubator_mxnet_tpu_torch.gluon import Trainer, data, nn
from incubator_mxnet_tpu_torch.gluon.data import DevicePrefetchRing
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1, ResNetV1)
from incubator_mxnet_tpu_torch.ops import fused_block

STEP_TOL, ADAM_TOL, MODEL_TOL = 1e-5, 1e-4, 2e-4
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
]
SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    for k, v in {"MXNET_USE_PALLAS": "0", "MXNET_FUSED_CONV3": "0"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MXNET_TRAIN_CHUNK_STEPS", raising=False)
    monkeypatch.delenv("MXTPU_TRAIN_CHUNK_STEPS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dense(seed=0):
    """``tests/test_fuse_loop.py:_net`` without dropout."""
    mx.random.seed(seed)
    net = jax_nn.HybridSequential()
    net.add(jax_nn.Dense(16, in_units=8, activation="relu"),
            jax_nn.Dense(5, in_units=16))
    net.initialize()
    net(nd.random.uniform(shape=(1, 8)))
    return net


def _weights(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _port_dense(weights=None, dropout=0.0):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(5, in_units=16))
    if weights is None:
        net.initialize(device="cpu",
                       generator=torch.Generator().manual_seed(0))
    else:
        params_from_jax(weights, net)
    return net


def _np_batches(n, bs=4, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.rand(bs, 8).astype("f"), rng.randint(0, 5, (bs,))
             .astype("i4")) for _ in range(n)]


def _tensors(batches):
    return [(torch.tensor(x), torch.tensor(y)) for x, y in batches]


def _step(opt="sgd", params=None, dropout=0.0, weights=None, **kw):
    return make_fused_train_step(
        _port_dense(weights, dropout), SoftmaxCrossEntropyLoss(), opt,
        dict(params or SGD), device="cpu", **kw)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    scale = max(np.abs(want).max() if want.size else 0.0, 1e-30)
    assert err <= tol * scale, (
        f"{what}: max|d| {err:.3e} > {tol} * {scale:.3e}")


def _jax_tree(jstep):
    """A JAX step's state under the port's ``state_tree`` names."""
    out = {f"params/{k}": np.asarray(v) for k, v in jstep.params.items()}
    out.update((f"aux/{k}", np.asarray(v)) for k, v in jstep.aux.items())
    for key, val in jstep.opt_state.items():
        if isinstance(val, dict):
            out.update((f"opt/{key}/{k}", np.asarray(v))
                       for k, v in val.items())
        else:
            out[f"opt/{key}"] = np.asarray(val)
    return out


def _bits(step):
    return {k: v.detach().clone() for k, v in step.state_tree().items()}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,params", OPTIMIZERS,
                         ids=[o for o, _ in OPTIMIZERS])
def test_chunked_records_and_state_match_jax(opt, params):
    batches = _np_batches(10)
    jnet = _jax_dense()
    weights = _weights(jnet)
    jstep = jax_fused(jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(), opt,
                      dict(params), chunk_steps=4)
    jloop = jstep.chunked_loop()
    want = jloop.run_epoch([(nd.array(x), nd.array(y)) for x, y in batches])
    step = _step(opt, params, weights=weights, chunk_steps=4)
    loop = step.chunked_loop()
    got = loop.run_epoch(_tensors(batches))
    assert [(r["kind"], r["steps"]) for r in got] == [
        (r["kind"], r["steps"]) for r in want] == [
        ("chunk", 4), ("chunk", 4), ("tail", 2)]
    for g, w in zip(got, want):
        assert g["loss"].dim() == 0
        np.testing.assert_allclose(g["loss"].item(), float(w["loss"]),
                                   rtol=1e-5)
    assert (loop.chunks_run, loop.tail_steps_run, loop.steps_run) == (
        jloop.chunks_run, jloop.tail_steps_run, jloop.steps_run)
    tol = ADAM_TOL if opt.startswith("adam") else STEP_TOL
    jtree = _jax_tree(jstep)
    mine = step.state_tree()
    assert sorted(mine) == sorted(jtree)
    for k, v in mine.items():
        _close(v.detach().numpy(), jtree[k], tol, f"{opt} {k}")


def _decode(payload):
    """A raw record → (float32 HWC image / 255, int32 label), numpy only."""
    header, img = recordio.unpack_raw(payload)
    return (img.astype(np.float32) / 255.0,
            np.int32(header.label))


def _jax_decode(payload):
    header, img = jax_recordio.unpack_raw(payload)
    return (img.astype(np.float32) / 255.0, np.int32(header.label))


def _write_rec(path, n, size, classes, seed=0):
    rng = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(str(path.with_suffix(".idx")),
                                   str(path), "w")
    for i in range(n):
        img = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_raw(
            recordio.IRHeader(0, float(rng.randint(0, classes)), i, 0), img))
    w.close()


def test_small_resnet_chunked_from_a_record_file_matches_jax(tmp_path):
    layers, channels = [1, 1, 1, 1], [16, 32, 64, 128, 256]
    params = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    rec = tmp_path / "train.rec"
    _write_rec(rec, 20, 64, 10)
    mx.random.seed(0)
    jnet = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, layers, channels,
                               classes=10, layout="NHWC", fused=True)
    jnet.initialize(ctx=mx.cpu())
    jnet(nd.zeros((1, 64, 64, 3)))              # resolve shapes
    net = ResNetV1(BottleneckV1, layers, channels, classes=10, layout="NHWC",
                   fused=True)
    params_from_jax(_weights(jnet), net)
    jloader = jax_gluon.data.DataLoader(
        jax_gluon.data.RecordFileDataset(str(rec)).transform(_jax_decode),
        batch_size=4)
    loader = data.DataLoader(
        data.RecordFileDataset(str(rec)).transform(_decode), batch_size=4,
        num_workers=2, thread_pool=False)
    jstep = jax_fused(jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      dict(params), chunk_steps=2)
    want = jstep.chunked_loop().run_epoch(jloader)
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 dict(params), device="cpu", chunk_steps=2)
    seen = []
    got = step.chunked_loop().run_epoch(loader, on_chunk=seen.append)
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "chunk", "chunk", "tail"]
    assert seen == got
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"].item(), float(w["loss"]),
                                   rtol=1e-5)
    jtree = _jax_tree(jstep)
    for k, v in step.state_tree().items():
        _close(v.detach().numpy(), jtree[k], MODEL_TOL, k)


def _jax_conv_net():
    """``tests/test_fuse.py:_net``."""
    mx.random.seed(0)
    net = jax_nn.HybridSequential()
    net.add(jax_nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False),
            jax_nn.BatchNorm(in_channels=4), jax_nn.Activation("relu"),
            jax_nn.GlobalAvgPool2D(), jax_nn.Flatten(),
            jax_nn.Dense(5, in_units=4))
    net.initialize()
    net(nd.random.uniform(shape=(1, 3, 8, 8)))
    return net


def _port_conv_net(weights):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5, in_units=4))
    params_from_jax(weights, net)
    return net


@pytest.mark.parametrize("remat", ["dots", "nothing"])
def test_remat_equals_the_plain_step_and_matches_jax_remat(remat):
    rng = np.random.RandomState(1)
    x = rng.rand(8, 3, 8, 8).astype("f")
    y = rng.randint(0, 5, (8,)).astype("i4")
    jnet = _jax_conv_net()
    weights = _weights(jnet)
    jstep = jax_fused(jnet, jax_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      dict(SGD), remat=remat)
    want = [float(jstep(nd.array(x), nd.array(y))) for _ in range(3)]
    runs = {}
    for r in (None, remat):
        step = make_fused_train_step(_port_conv_net(weights),
                                     SoftmaxCrossEntropyLoss(), "sgd",
                                     dict(SGD), device="cpu", remat=r)
        losses = [step(torch.tensor(x), torch.tensor(y)) for _ in range(3)]
        runs[r] = (losses, _bits(step), step)
    assert [v.item() for v in runs[remat][0]] == [
        v.item() for v in runs[None][0]]
    _assert_bitwise(runs[remat][1], runs[None][1])
    np.testing.assert_allclose([v.item() for v in runs[remat][0]], want,
                               rtol=1e-5)
    jtree = _jax_tree(jstep)
    for k, v in runs[remat][1].items():
        _close(v.numpy(), jtree[k], STEP_TOL, k)
    assert len(runs[remat][2]._segments) == 6


@pytest.mark.parametrize("remat", ["dots", "nothing"])
def test_remat_recompute_leaves_the_moving_statistics_alone(remat):
    """With checkpointing's early stop off, a BatchNorm layer's recompute
    runs through its moving-statistics update: the update must not be
    applied a second time."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.rand(8, 3, 8, 8).astype("f"))
    y = torch.tensor(rng.randint(0, 5, (8,)).astype("i4"))
    weights = _weights(_jax_conv_net())
    runs = []
    for r in (None, remat):
        step = make_fused_train_step(_port_conv_net(weights),
                                     SoftmaxCrossEntropyLoss(), "sgd",
                                     dict(SGD), device="cpu", remat=r)
        with set_checkpoint_early_stop(False):
            for _ in range(2):
                step(x, y)
        runs.append(_bits(step))
    _assert_bitwise(runs[0], runs[1])


@pytest.mark.parametrize("remat", ["dots", "nothing"])
def test_remat_with_dropout_is_bit_for_bit_the_plain_step(remat):
    """The recompute replays the first run's masks, so the default
    generator advances as without remat and every number is equal."""
    batches = _tensors(_np_batches(3))
    runs = []
    for r in (None, remat):
        torch.manual_seed(7)
        step = _step(dropout=0.5, remat=r)
        losses = [step(x, y).item() for x, y in batches]
        runs.append((losses, _bits(step), torch.rand(3)))
    assert runs[0][0] == runs[1][0]
    _assert_bitwise(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])


@pytest.mark.parametrize("remat,launches", [(None, 1), ("dots", 1),
                                            ("nothing", 2)])
def test_remat_recomputes_the_fused_products_as_its_policy_says(
        monkeypatch, remat, launches):
    """One step of the small fused ResNet: ``"nothing"`` runs each fused
    1x1's forward twice (the recompute), ``"dots"`` once (the product is
    kept); the state equals the plain step's bit for bit."""
    calls = []
    real = fused_block.fused_matmul_bn_fwd

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_block, "fused_matmul_bn_fwd", counted)
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.rand(2, 32, 32, 3).astype(np.float32))
    y = torch.tensor(rng.randint(0, 10, 2).astype(np.int32))
    out = {}
    for r in (None, remat):
        net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                       classes=10, layout="NHWC", fused=True).initialize(
            device="cpu", generator=torch.Generator().manual_seed(0))
        step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     dict(SGD), device="cpu", remat=r)
        calls.clear()
        out[r] = (step(x, y).item(), _bits(step))
        assert len(calls) == 12 * (launches if r else 1), (r, len(calls))
    assert out[None][0] == out[remat][0]
    _assert_bitwise(out[None][1], out[remat][1])


# ---------------------------------------------------------------------------
# the port against itself, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_chunked_equals_sequential_bit_for_bit(dropout):
    batches = _tensors(_np_batches(10))
    torch.manual_seed(3)
    seq = _step(dropout=dropout)
    losses = [seq(x, y) for x, y in batches]
    torch.manual_seed(3)
    ch = _step(dropout=dropout, chunk_steps=4)
    loop = ch.chunked_loop()
    recs = loop.run_epoch(batches)
    assert [r["kind"] for r in recs] == ["chunk", "chunk", "tail"]
    assert loop.compile_count == 0          # the CPU captures no graph
    _assert_bitwise(_bits(seq), _bits(ch))
    f32 = [v.float() for v in losses]
    assert recs[0]["loss"].dtype == torch.float32
    assert recs[0]["loss"].item() == ((f32[0] + f32[1] + f32[2] + f32[3])
                                      / 4).item()
    assert recs[2]["loss"].item() == ((losses[8] + losses[9]) / 2).item()
    assert torch.equal(torch.cat([r["losses"] for r in recs]),
                       torch.stack(f32))


def test_k1_is_the_per_step_path_bit_for_bit():
    batches = _tensors(_np_batches(6))
    seq = _step()
    for x, y in batches:
        seq(x, y)
    ch = _step(chunk_steps=1)
    loop = ch.chunked_loop()
    recs = loop.run_epoch(batches)
    assert all(r["kind"] == "step" and r["steps"] == 1 for r in recs)
    assert loop.compile_count == 0 and loop.ring is None
    assert loop.steps_run == loop.tail_steps_run == 6
    _assert_bitwise(_bits(seq), _bits(ch))


def test_tail_equals_the_per_step_continuation_bit_for_bit():
    batches = _tensors(_np_batches(10))
    full = _step(chunk_steps=4)
    full.chunked_loop().run_epoch(batches)
    manual = _step(chunk_steps=4)
    manual.chunked_loop().run_epoch(batches[:8])
    for x, y in batches[8:]:
        manual(x, y)
    _assert_bitwise(_bits(full), _bits(manual))


def test_run_chunk_and_a_block_of_device_blocks():
    """``run_chunk`` takes a stacked block directly; a chunk's mean loss
    equals the sequential steps' mean."""
    batches = _tensors(_np_batches(4))
    seq = _step()
    losses = [seq(x, y).item() for x, y in batches]
    ch = _step(chunk_steps=4)
    loop = ch.chunked_loop()
    loss = loop.run_chunk(torch.stack([x for x, _ in batches]),
                          torch.stack([y for _, y in batches]))
    assert loop.chunks_run == 1 and loop.steps_run == 4
    np.testing.assert_allclose(loss.item(), np.mean(losses), rtol=1e-6)


# ---------------------------------------------------------------------------
# errors and settings, matched to the JAX package
# ---------------------------------------------------------------------------

def test_run_chunk_errors_match_jax():
    with pytest.raises(RuntimeError, match="chunk_steps == 1"):
        _step(chunk_steps=1).chunked_loop().run_chunk(None, None)
    loop = _step(chunk_steps=4).chunked_loop()
    with pytest.raises(ValueError, match="loop compiled for chunks of 4"):
        loop.run_chunk(torch.zeros(2, 4, 8),
                       torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="chunk_steps"):
        ChunkedTrainLoop(_step(chunk_steps=4), chunk_steps=0)
    with pytest.raises(ValueError, match="chunk_steps"):
        _step(chunk_steps=-2)
    with pytest.raises(ValueError, match="remat must be None, 'dots' or "
                                         "'nothing'; got 'all'"):
        _step(remat="all")
    with pytest.raises(NotImplementedError, match="item 11"):
        _step(mesh=object())


def test_resolve_chunk_steps_env_default_and_range(monkeypatch):
    from incubator_mxnet_tpu.base import resolve_chunk_steps as jax_resolve
    assert base.resolve_chunk_steps() == jax_resolve() == 1
    for name in ("MXNET_TRAIN_CHUNK_STEPS", "MXTPU_TRAIN_CHUNK_STEPS"):
        monkeypatch.setenv(name, "5")
        assert base.resolve_chunk_steps() == jax_resolve() == 5
        assert base.resolve_chunk_steps(3) == 3
        assert _step().chunk_steps == 5
        assert _step().chunked_loop(2).chunk_steps == 2
        monkeypatch.delenv(name)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="chunk_steps must be >= 1"):
            base.resolve_chunk_steps(bad)
        with pytest.raises(ValueError, match="chunk_steps must be >= 1"):
            jax_resolve(bad)


def test_trainer_takes_the_chunk_budget_and_a_checkpoint_dir(
        monkeypatch, tmp_path):
    net = _port_dense()
    monkeypatch.setenv("MXNET_TRAIN_CHUNK_STEPS", "5")
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                 kvstore=None, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_keep=2)
    assert tr._chunk_steps == 5 and tr._ckpt.keep == 2
    assert tr._ckpt.directory == str(tmp_path / "ck")
    assert Trainer(net.collect_params(), "sgd", chunk_steps=3,
                   kvstore=None)._ckpt is None
    with pytest.raises(ValueError, match="chunk_steps"):
        Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                chunk_steps=0)


def test_donate_false_keeps_what_the_caller_took():
    batches = _tensors(_np_batches(3))
    for opt, params in (OPTIMIZERS[0], OPTIMIZERS[2]):
        kept = _step(opt, params, donate=False)
        donating = _step(opt, params)
        taken = {k: v for k, v in kept.state_tree().items()}
        before = {k: v.detach().clone() for k, v in taken.items()}
        donated = dict(donating.state_tree())
        for x, y in batches:
            assert kept(x, y).item() == donating(x, y).item()
        for k, v in taken.items():
            assert torch.equal(v, before[k]), k     # untouched
        _assert_bitwise(_bits(kept), _bits(donating))
        assert all(a is b for a, b in zip(donated.values(),
                                          donating.state_tree().values()))
        assert not torch.equal(donated["params/0.weight"],
                               before["params/0.weight"])
    # what a caller sets in the handed-out state is what the next call uses
    kept = _step(donate=False)
    ref = _step()
    with torch.no_grad():
        kept.params["0.weight"].mul_(0.5)
        ref.params["0.weight"].mul_(0.5)
    x, y = batches[0]
    assert kept(x, y).item() == ref(x, y).item()


def test_state_tree_round_trip_resumes_bit_for_bit():
    batches = _tensors(_np_batches(10))
    full = _step("adam", {"learning_rate": 0.01}, chunk_steps=2)
    saved = {}
    full.chunked_loop().run_epoch(
        batches, on_chunk=lambda rec: saved.setdefault(
            len(saved), {k: v.detach().clone()
                         for k, v in full.state_tree().items()}))
    assert len(saved) == 5
    resumed = _step("adam", {"learning_rate": 0.01}, chunk_steps=2)
    resumed.load_state_tree(saved[1])
    resumed.chunked_loop().run_epoch(batches[4:])
    _assert_bitwise(_bits(full), _bits(resumed))
    with pytest.raises(KeyError, match="mismatch"):
        resumed.load_state_tree({"params/0.weight": saved[1][
            "params/0.weight"]})


def test_example_runs_chunked_on_the_cpu(capsys):
    train_resnet_fused.main(["--cpu", "--batch", "2", "--image-size", "64",
                             "--steps", "3", "--classes", "10",
                             "--chunk-steps", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-2]
    res = json.loads(line)
    assert (res["chunk_steps"], res["chunks"], res["tail_steps"],
            res["loop_compiles"]) == (2, 1, 1, 0)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()


# ---------------------------------------------------------------------------
# the device prefetch ring (on the CPU: blocks stacked on the host)
# ---------------------------------------------------------------------------

def _ring(batches, k, **kw):
    return list(DevicePrefetchRing(batches, k, device="cpu", **kw))


def test_ring_groups_blocks_in_order_with_a_tail_like_jax():
    rng = np.random.RandomState(0)
    batches = [(rng.rand(2, 3).astype("f"), rng.rand(2).astype("f"))
               for _ in range(7)]
    for depth in (1, 2, 3):
        out = _ring(batches, 3, depth=depth)
        want = list(JaxRing(batches, 3))
        assert [b[0] for b in out] == [b[0] for b in want] == [
            "chunk", "chunk", "tail"]
        for (_, xs, ys), (_, jx, jy) in zip(out[:2], want[:2]):
            assert xs.shape == (3, 2, 3) and ys.shape == (3, 2)
            np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ys.numpy(), np.asarray(jy))
        assert len(out[2][1]) == 1
        np.testing.assert_array_equal(np.asarray(out[2][1][0][0]),
                                      batches[6][0])


def test_ring_numpy_and_tensor_sources_agree():
    rng = np.random.RandomState(0)
    np_batches = [(rng.rand(2, 3), rng.randint(0, 4, (2,)).astype("i4"))
                  for _ in range(4)]
    a = _ring(np_batches, 2)
    b = _ring([(torch.tensor(x), torch.tensor(y)) for x, y in np_batches], 2)
    assert len(a) == len(b) == 2
    for (ka, xa, ya), (kb, xb, yb) in zip(a, b):
        assert ka == kb == "chunk"
        assert xa.dtype == torch.float32 and ya.dtype == torch.int32
        assert torch.equal(xa, xb.float()) and torch.equal(ya, yb)


def test_ring_exact_multiple_has_no_tail_and_empty_is_empty():
    batches = _np_batches(4)
    ring = DevicePrefetchRing(batches, 2, device="cpu")
    assert [b[0] for b in ring] == ["chunk", "chunk"]
    assert ring.blocks == 2 and ring.tail_steps == 0 and ring.wait_s >= 0
    assert _ring([], 2) == []
    with pytest.raises(ValueError, match="chunk_steps"):
        DevicePrefetchRing(batches, 0, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetchRing(batches, 2, depth=0, device="cpu")
