"""Saving and resuming in the port against the JAX package, on the CPU.

* ``.params`` files (``ndarray.save``/``load``): round trips in every
  type flag, named and unnamed; the port's bytes equal the JAX writer's
  for the same arrays; files cross both ways; the older V1, V3 and
  ndim-magic records and the JAX package's MXTPU001 container read as
  the JAX reader reads them; sparse records and 0-dim arrays raise.
* ``Block.save_parameters``/``load_parameters``: across packages both
  ways, ``allow_missing``, ``ignore_extra``, a deferred layer taking the
  file's shape, and ``cast``.
* ``Trainer.save_states``/``load_states``: a states file crosses both
  ways without ``multi_precision``, and the port's multi-precision file
  (its nested states converted at every level) is read by the JAX
  ``Updater.set_states``, whose own ``get_states`` cannot write it.  The
  next update after loading equals the uninterrupted run's: float32 at
  1e-6 of the largest value, bfloat16 to the bit.
* A small bfloat16 BERT trained with LAMB, ``multi_precision``, a
  warm-up schedule and ``wd_mult = 0`` on LayerNorm parameters and
  biases, saved after 2 steps and resumed in a fresh model and trainer
  with ``begin_num_update=2``: its next 2 steps equal the last 2 of an
  uninterrupted 4-step run bit for bit (the CPU is deterministic).
"""
import os
import pickle
import struct

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd as jax_nd
from incubator_mxnet_tpu.ndarray import NDArray
from incubator_mxnet_tpu.ndarray import params_io as jax_params_io
from incubator_mxnet_tpu.ndarray.sparse import RowSparseNDArray

from incubator_mxnet_tpu_torch import amp, autograd
from incubator_mxnet_tpu_torch import ndarray as nd
from incubator_mxnet_tpu_torch.examples.train_bert import (pretraining_loss,
                                                           synthetic_batch)
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.ndarray import params_io
from incubator_mxnet_tpu_torch.optimizer import Updater, create
from incubator_mxnet_tpu_torch.optimizer.lr_scheduler import PolyScheduler

DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
          "int64", "bool", "bfloat16"]


def _numpy(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(*shape) > 0.5
    if dtype in ("uint8", "int8", "int32", "int64"):
        return rng.randint(0, 100, shape).astype(dtype)
    if dtype == "bfloat16":
        return rng.randn(*shape).astype(ml_dtypes.bfloat16)
    return rng.randn(*shape).astype(dtype)


def _port(arr):
    """A tensor of its own (updates in place must not reach ``arr``)."""
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).bfloat16()
    return torch.from_numpy(arr.copy())


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _arrays():
    return {f"p{i}.{dt}": _numpy(dt, shape, i) for i, (dt, shape) in
            enumerate(zip(DTYPES, [(3, 4), (5,), (2, 3, 2), (7,), (1, 1),
                                   (4, 2), (3,), (2, 5), (6, 3)]))}


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_round_trip_in_every_type_flag(dtype, tmp_path):
    arr = _numpy(dtype, (4, 3), 1)
    t = _port(arr)
    f = str(tmp_path / "a.params")
    nd.save(f, {"x": t, "y": t[1:]})
    back = nd.load(f)
    assert list(back) == ["x", "y"]
    assert back["x"].dtype == t.dtype and torch.equal(back["x"], t)
    assert torch.equal(back["y"], t[1:])
    nd.save(f, [t, t.T])           # unnamed list; a transposed view
    a, b = nd.load(f)
    assert torch.equal(a, t) and torch.equal(b, t.T.contiguous())


def _jax_arrays():
    """The arrays a JAX NDArray holds as they are: without x64, JAX keeps
    no float64 or int64 array (``jnp.asarray`` narrows them)."""
    return {k: v for k, v in _arrays().items()
            if v.dtype not in (np.float64, np.int64)}


def test_writer_gives_the_jax_writers_bytes(tmp_path):
    arrays = _jax_arrays()
    mine, theirs = str(tmp_path / "port.params"), str(tmp_path / "jax.params")
    nd.save(mine, {k: _port(v) for k, v in arrays.items()})
    jax_nd.save(theirs, {k: NDArray(jnp.asarray(v)) for k, v in
                         arrays.items()})
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    everything = _arrays()       # the codec itself, in every type flag
    for named in (True, False):
        assert params_io.save_bytes(
            [(k, _port(v)) for k, v in everything.items()], named) == \
            jax_params_io.save_bytes(list(everything.items()), named)


def test_files_cross_both_ways(tmp_path):
    arrays = _jax_arrays()
    f = str(tmp_path / "a.params")
    jax_nd.save(f, {k: NDArray(jnp.asarray(v)) for k, v in arrays.items()})
    got = nd.load(f)
    for k, v in arrays.items():
        np.testing.assert_array_equal(_as_numpy(got[k]), v)
        assert _as_numpy(got[k]).dtype == v.dtype
    nd.save(f, got)
    back = jax_nd.load(f)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)


def _record(magic, shape, flag, raw, v3_dims=True):
    if magic == "oldest":
        head = struct.pack("<I", len(shape)) + struct.pack(
            f"<{len(shape)}I", *shape)
    else:
        head = struct.pack("<I", magic)
        if magic != params_io.V1_MAGIC:
            head += struct.pack("<i", 0)
        head += struct.pack("<i", len(shape)) + struct.pack(
            f"<{len(shape)}q", *shape)
    return head + struct.pack("<iii", 1, 0, flag) + raw


@pytest.mark.parametrize("magic", [params_io.V1_MAGIC, params_io.V3_MAGIC,
                                   "oldest"])
def test_older_records_read_as_jax_reads_them(magic):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.arange(5, dtype=np.int64)
    body = (_record(magic, a.shape, 0, a.tobytes())
            + _record(magic, b.shape, 6, b.tobytes()))
    names = [b"w", b"idx"]
    buf = struct.pack("<QQQ", 0x112, 0, 2) + body + struct.pack(
        "<Q", 2) + b"".join(struct.pack("<Q", len(n)) + n for n in names)
    got, got_names = params_io.load_bytes(buf)
    want, want_names = jax_params_io.load_bytes(buf)
    assert got_names == want_names == ["w", "idx"]
    for g, (w, stype, aux, shape) in zip(got, want):
        assert stype == 0 and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_mxtpu001_container_reads(tmp_path):
    f = str(tmp_path / "old.params")
    entries = [("w", "float32", np.arange(6, dtype=np.float32).reshape(2, 3)),
               ("h", "bfloat16", np.array([1.5, -2.25], np.float32))]
    with open(f, "wb") as out:
        out.write(b"MXTPU001" + struct.pack("<q", len(entries)))
        for key, dt, arr in entries:
            for s in (key.encode(), dt.encode()):
                out.write(struct.pack("<q", len(s)) + s)
            out.write(struct.pack("<q", arr.ndim))
            out.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            out.write(struct.pack("<q", arr.nbytes) + arr.tobytes())
    got, want = nd.load(f), jax_nd.load(f)
    assert list(got) == list(want) == ["w", "h"]
    assert got["h"].dtype == torch.bfloat16
    for k in got:
        np.testing.assert_array_equal(_as_numpy(got[k]), want[k].asnumpy())


def test_sparse_records_and_0_dim_arrays_raise(tmp_path):
    f = str(tmp_path / "s.params")
    jax_nd.save(f, {"rs": RowSparseNDArray(np.ones((2, 3), np.float32),
                                           [0, 2], (4, 3))})
    with pytest.raises(NotImplementedError, match="item 12"):
        nd.load(f)
    with pytest.raises(ValueError, match="0-dim"):
        nd.save(f, {"s": torch.tensor(1.0)})
    with pytest.raises(NotImplementedError, match="item 12"):
        nd.save(f, {"s": torch.eye(3).to_sparse()})


class _Net(nn.HybridSequential):
    def __init__(self, hidden_in=0, out=3):
        super().__init__()
        self.add(nn.Dense(5, in_units=hidden_in), nn.LayerNorm(in_channels=5),
                 nn.Dense(out, in_units=5))


def _jax_net():
    mx.random.seed(0)
    net = jax_gluon.nn.HybridSequential()
    net.add(jax_gluon.nn.Dense(5, in_units=4),
            jax_gluon.nn.LayerNorm(in_channels=5),
            jax_gluon.nn.Dense(3, in_units=5))
    net.initialize()
    return net


def test_block_parameters_cross_both_ways(tmp_path):
    f = str(tmp_path / "net.params")
    jnet = _jax_net()
    jnet.save_parameters(f)
    net = _Net(4).initialize(device="cpu")
    net.load_parameters(f)
    want = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    got = {k: p.detach().numpy() for k, p in net.collect_params().items()}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(2)
    net.save_params(f)                  # the alias
    jnet.load_params(f)
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), 2 * want[k])


def test_load_parameters_missing_extra_and_deferred(tmp_path):
    f = str(tmp_path / "net.params")
    src = _Net(4).initialize(device="cpu",
                             generator=torch.Generator().manual_seed(1))
    src.save_parameters(f)
    deferred = _Net().initialize(device="cpu")   # the first Dense deferred
    deferred.load_parameters(f)
    for (k, a), b in zip(src.collect_params().items(),
                         deferred.collect_params().values()):
        assert torch.equal(a, b), k
    x = torch.randn(2, 4)
    assert torch.equal(deferred(x), src(x))   # no re-initialisation

    wider = _Net(4, out=6).initialize(device="cpu")
    with pytest.raises(ValueError, match="shape"):
        wider.load_parameters(f)
    params = {k: p.detach() for k, p in src.collect_params().items()}
    nd.save(f, {k: v for k, v in params.items() if k != "1.beta"})
    target = _Net(4).initialize(device="cpu")
    before = {k: p.clone() for k, p in target.collect_params().items()}
    with pytest.raises(KeyError, match="1.beta"):
        target.load_parameters(f)
    for k, p in target.collect_params().items():    # nothing written
        assert torch.equal(p, before[k])
    target.load_parameters(f, allow_missing=True)
    assert torch.equal(target[1].beta, before["1.beta"])
    assert torch.equal(target[0].weight, src[0].weight)
    nd.save(f, dict(params, extra=torch.zeros(2)))
    with pytest.raises(KeyError, match="extra"):
        target.load_parameters(f)
    target.load_parameters(f, ignore_extra=True)


def test_cast_keeps_the_parameter_objects():
    net = _Net(4).initialize(device="cpu")
    w = net[0].weight
    x = torch.randn(2, 4)
    with autograd.record():
        net(x).sum().backward()
    assert net.cast("bfloat16") is net
    assert w is net[0].weight and w.dtype == torch.bfloat16
    assert w.grad.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    lazy = _Net().initialize(device="cpu").cast("float64")
    lazy(torch.randn(2, 4, dtype=torch.float64))
    assert lazy[0].weight.dtype == torch.float64


def _param_run(kind, name, opt, w, grads, states=None, begin=0):
    """Updates of one weight by the given package's Trainer; returns the
    weights after each step and the states file after the last."""
    opt = dict(opt, begin_num_update=begin)
    out = []
    if kind == "jax":
        p = jax_gluon.Parameter("w", shape=w.shape)
        p.initialize(init=mx.init.Constant(0.0))
        p.set_data(NDArray(jnp.asarray(w)))
        if w.dtype == ml_dtypes.bfloat16:
            p.cast("bfloat16")
            p.set_data(NDArray(jnp.asarray(w)))
        t = jax_gluon.Trainer({"w": p}, name, opt, kvstore=None)
        if states is not None:
            t._updaters[0].set_states(states)
        for g in grads:
            with jax_autograd.record():
                loss = (p.data() * NDArray(jnp.asarray(g).astype(
                    p.data().dtype))).sum()
            loss.backward()
            t.step(1)
            out.append(np.asarray(p.data().data.astype(jnp.float32)))
        try:
            saved = t._updaters[0].get_states()
        except TypeError:              # nested NDArray states: finding 2
            saved = None
        return out, saved
    p = torch.nn.Parameter(_port(w))
    t = Trainer({"w": p}, name, opt, kvstore=None)
    if states is not None:
        t._updater.set_states(states)
    for g in grads:
        with autograd.record():
            loss = (p * _port(g).to(p.dtype)).sum()
        autograd.backward(loss)
        t.step(1)
        assert p.grad is None
        out.append(p.detach().float().numpy().copy())
    return out, t._updater.get_states()


CROSS = [("adam", dict(learning_rate=0.01, wd=0.01), "float32"),
         ("lamb", dict(learning_rate=0.01, wd=0.01), "float32"),
         ("nag", dict(learning_rate=0.1, momentum=0.9), "float32"),
         ("rmsprop", dict(learning_rate=0.01, centered=True), "float32")]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name,opt,dtype", CROSS,
                         ids=[c[0] for c in CROSS])
def test_states_cross_packages_and_resume(name, opt, dtype, writer):
    """Two steps by ``writer``, its states file, then two more steps by
    the other package from that file (``begin_num_update=2``): equal to
    the reader's own uninterrupted 4 steps."""
    rng = np.random.RandomState(2)
    w = rng.randn(6, 5).astype(dtype)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(4)]
    reader = "port" if writer == "jax" else "jax"
    whole, _ = _param_run(reader, name, opt, w, grads)
    first, states = _param_run(writer, name, opt, w, grads[:2])
    rest, _ = _param_run(reader, name, opt, first[-1].astype(dtype),
                         grads[2:], states=states, begin=2)
    for a, b in zip(rest, whole[2:]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def test_multi_precision_states_are_saved_and_read_by_jax():
    """LAMB with a float32 master on a bfloat16 weight: the JAX package
    cannot pickle its own nested states (its ``get_states`` raises); the
    port's file holds them as numpy at every level, and the JAX
    ``Updater.set_states`` reads it: the next two JAX updates then equal
    JAX's own uninterrupted ones, to the bit."""
    rng = np.random.RandomState(3)
    w = rng.randn(6, 5).astype(ml_dtypes.bfloat16)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(4)]
    opt = dict(learning_rate=0.01, wd=0.01, multi_precision=True)
    whole, jax_saved = _param_run("jax", "lamb", opt, w, grads[:2])
    assert jax_saved is None
    whole, _ = _param_run("jax", "lamb", opt, w, grads)
    first, states = _param_run("port", "lamb", opt, w, grads[:2])
    saved = pickle.loads(states)
    master, (m, v) = saved[0]
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in (master, m, v))
    for a, b in zip(first, whole):
        np.testing.assert_array_equal(a, b)
    rest, _ = _param_run("jax", "lamb", opt,
                         first[-1].astype(ml_dtypes.bfloat16), grads[2:],
                         states=states, begin=2)
    for a, b in zip(rest, whole[2:]):
        np.testing.assert_array_equal(a, b)


def test_loaded_state_is_used_not_recreated():
    """After ``set_states`` the next update continues from the file's
    state on the weight's device and dtype (a fresh zero state would
    give another update), and ``get_states`` before that update still
    holds it; ``dump_optimizer`` carries the counts."""
    opt = create("adam", learning_rate=0.1)
    up = Updater(opt)
    w = torch.ones(4)
    for _ in range(3):
        up(0, torch.full((4,), 0.5), w)
    blob = up.get_states(dump_optimizer=True)
    resumed = Updater(create("adam", learning_rate=0.1))
    resumed.set_states(blob)
    assert pickle.loads(resumed.get_states())[0][0].tolist() == \
        up.states[0][0].tolist()
    fresh = Updater(create("adam", learning_rate=0.1, begin_num_update=3))
    w2, w3 = w.clone(), w.clone()
    up(0, torch.full((4,), 0.5), w)
    resumed(0, torch.full((4,), 0.5), w2)
    fresh(0, torch.full((4,), 0.5), w3)
    assert torch.equal(w, w2) and not torch.equal(w, w3)
    assert resumed.optimizer._index_update_count == {0: 4}
    with pytest.raises(ValueError, match="structure"):
        bad = Updater(create("sgd", momentum=0.9))
        bad.set_states(up.get_states())
        bad(0, torch.zeros(4), torch.ones(4))


CFG = dict(vocab_size=60, num_layers=2, units=32, hidden_size=64,
           num_heads=2, max_length=16, dropout=0.0)
B, T, N = 3, 16, 2


def _bert(seed=0):
    net = BERTModel(**CFG).initialize(
        device="cpu", generator=torch.Generator().manual_seed(seed))
    return amp.convert_block(net, "bfloat16")


def _no_decay(net):
    for k, p in net.collect_params().items():
        if k.endswith(("gamma", "beta", "bias")):
            p.wd_mult = 0.0


def _lamb(net, begin=0):
    return Trainer(net.collect_params(), "lamb", {
        "learning_rate": 1e-2, "multi_precision": True, "wd": 0.01,
        "begin_num_update": begin,
        "lr_scheduler": PolyScheduler(max_update=2 * N, base_lr=1e-2, pwr=1,
                                      warmup_steps=2)})


def _steps(net, trainer, batch, n):
    ce = SoftmaxCrossEntropyLoss()
    out = []
    for _ in range(n):
        with autograd.record():
            loss = pretraining_loss(net, ce, *batch)
        autograd.backward(loss)
        trainer.step(B)
        out.append((loss.float().item(), trainer.learning_rate))
    return out


def test_bert_resume_equals_the_uninterrupted_run(tmp_path):
    batch = [torch.from_numpy(a) for a in synthetic_batch(B, T, 60)]
    whole = _bert()
    _no_decay(whole)
    whole_log = _steps(whole, _lamb(whole), batch, 2 * N)

    net = _bert()
    _no_decay(net)
    trainer = _lamb(net)
    first = _steps(net, trainer, batch, N)
    pf, sf = str(tmp_path / "bert.params"), str(tmp_path / "bert.states")
    net.save_parameters(pf)
    trainer.save_states(sf)
    saved = nd.load(pf)
    assert saved["word_embed.weight"].dtype == torch.bfloat16
    assert saved["embed_ln.gamma"].dtype == torch.float32

    fresh = _bert(seed=7)
    fresh.load_parameters(pf)
    _no_decay(fresh)
    resumed = _lamb(fresh, begin=N)
    resumed.load_states(sf)
    rest = _steps(fresh, resumed, batch, N)
    assert first + rest == whole_log
    assert [lr for _, lr in whole_log] == [0.005, 0.01, 0.005, 0.0]
    for (k, a), b in zip(whole.collect_params().items(),
                         fresh.collect_params().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    states = resumed._updater.states
    assert len(states) == len(list(fresh.parameters()))
    index = list(fresh.collect_params()).index("word_embed.weight")
    master, (m, v) = states[index]           # a bfloat16 weight's
    assert master.dtype == m.dtype == torch.float32
    assert torch.equal(master.bfloat16(), fresh.word_embed.weight)
    losses = [v for v, _ in whole_log]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
