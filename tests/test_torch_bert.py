"""BERT of the PyTorch port against the JAX package's, on the CPU.

A small BERT is built and initialised in JAX, its weights carried over
with ``convert.params_from_jax``, and both forwards compared on the
same numpy inputs.  Tolerance float32 rtol=atol=1e-4: two layers of
matrix products summed in another order.

Both models converted to bfloat16 by ``amp.convert_block`` (what
``examples/train_bert.py --amp`` runs), the JAX model's converted
weights carried across: the predict-mode MLM and NSP logits and one
training-mode loss, within AMP_TOL = 2e-2 of the largest |JAX| value
(``tests/test_torch_amp.py``'s bound).  The test requires the JAX
model's own bfloat16-vs-float32 distance (5.6e-3 and 4.9e-3 of the
largest logit when the bound was set) to stay below AMP_TOL / 2, so the
bound sits above bfloat16's own noise; port and JAX were 3.4e-3 and
2.9e-3 apart, and their losses equal.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import amp as jax_amp
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT

from incubator_mxnet_tpu_torch import amp, autograd
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import BERTModel

CFG = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
           num_heads=4, max_length=32)
TOL = dict(rtol=1e-4, atol=1e-4)
AMP_TOL = 2e-2


@pytest.fixture(scope="module")
def jax_model():
    mx.random.seed(0)
    net = JaxBERT(**CFG)
    net.initialize()
    return net


def _named(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], (3, 16)).astype(np.int32)
    tokens[1, 3] = 150      # past the table: clipped to the last row
    tokens[2, 0] = -3       # below it: clipped to row 0
    types = rng.integers(0, 2, (3, 16)).astype(np.int32)
    valid = np.array([16, 9, 1], np.int32)
    return tokens, types, valid


def test_names_and_shapes_match_jax(jax_model):
    port = BERTModel(**CFG)
    want = {k: v.shape for k, v in _named(jax_model).items()}
    got = {k: tuple(p.shape) for k, p in port.collect_params().items()}
    assert list(got) == list(want)
    assert got == want


def test_forward_matches_jax(jax_model):
    port = BERTModel(**CFG)
    params_from_jax(_named(jax_model), port)
    port.eval()
    tokens, types, valid = _inputs()
    want = [o.asnumpy() for o in jax_model(
        nd.array(tokens, dtype="int32"), nd.array(types, dtype="int32"),
        nd.array(valid, dtype="int32"))]
    with torch.inference_mode():
        got = [o.numpy() for o in port(torch.from_numpy(tokens),
                                       torch.from_numpy(types),
                                       torch.from_numpy(valid))]
    assert [g.shape for g in got] == [(3, 16, 100), (3, 2)]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)


def test_out_of_range_tokens_read_the_edge_rows(jax_model):
    port = BERTModel(**CFG)
    params_from_jax(_named(jax_model), port)
    port.eval()
    tokens, types, valid = _inputs()
    clipped = np.clip(tokens, 0, CFG["vocab_size"] - 1)
    with torch.inference_mode():
        a = port(torch.from_numpy(tokens), torch.from_numpy(types),
                 torch.from_numpy(valid))
        b = port(torch.from_numpy(clipped), torch.from_numpy(types),
                 torch.from_numpy(valid))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("edit", ["missing", "extra", "shape"])
def test_params_from_jax_rejects_mismatch(jax_model, edit):
    named = _named(jax_model)
    if edit == "missing":
        del named["encoder.layer1.ln2.beta"]
    elif edit == "extra":
        named["encoder.layer2.ln1.gamma"] = np.ones(64, np.float32)
    else:
        named["pooler.weight"] = np.zeros((64, 63), np.float32)
    port = BERTModel(**CFG)
    port.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError):
        params_from_jax(named, port)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k])


def test_initialize_is_seeded_and_follows_jax_defaults():
    def build(seed):
        return BERTModel(**CFG).initialize(
            device="cpu", generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.word_embed.weight, c.word_embed.weight)
    p = a.collect_params()
    assert torch.equal(p["embed_ln.gamma"], torch.ones(64))
    assert torch.equal(p["encoder.layer0.ln1.beta"], torch.zeros(64))
    assert torch.equal(p["pooler.bias"], torch.zeros(64))
    w = p["encoder.layer0.ffn1.weight"]
    assert w.abs().max() <= 0.07 and w.std() > 0.03   # Uniform(0.07)
    assert 0.015 < p["pos_embed"].std() < 0.025        # Normal(0.02)
    assert a.hybridize() is a
    assert list(a.collect_params(select=r"encoder\.layer1\.ln")) == [
        "encoder.layer1.ln1.gamma", "encoder.layer1.ln1.beta",
        "encoder.layer1.ln2.gamma", "encoder.layer1.ln2.beta"]


def _pretraining_loss(ce, mlm, nsp, y_mlm, y_nsp):
    return (ce(mlm.reshape(y_mlm.shape[0], -1), y_mlm).mean()
            + ce(nsp, y_nsp).mean())


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def jax_amp_model():
    """A JAX BERT of CFG without dropout (the training-mode loss then
    draws nothing at random): its float32 logits, then, converted to
    bfloat16, its weights (numpy, bfloat16 where cast), its logits and a
    training-mode pretraining loss."""
    tokens, types, valid = _inputs()
    rng = np.random.default_rng(1)
    y_mlm = rng.integers(0, CFG["vocab_size"], tokens.size).astype(np.int32)
    y_nsp = rng.integers(0, 2, tokens.shape[0]).astype(np.int32)
    args = (nd.array(tokens, dtype="int32"), nd.array(types, dtype="int32"),
            nd.array(valid, dtype="int32"))
    mx.random.seed(0)
    net = JaxBERT(dropout=0.0, **CFG)
    net.initialize()
    f32 = [o.asnumpy() for o in net(*args)]
    jax_amp.convert_block(net, "bfloat16")
    weights = {k: np.asarray(p.data().data)
               for k, p in net.collect_params().items()}
    bf16 = [o.asnumpy().astype(np.float32) for o in net(*args)]
    with jax_autograd.record():
        mlm, nsp = net(*args)
        loss = _pretraining_loss(jax_gluon.loss.SoftmaxCrossEntropyLoss(),
                                 mlm, nsp, nd.array(y_mlm), nd.array(y_nsp))
    return dict(weights=weights, f32=f32, bf16=bf16, labels=(y_mlm, y_nsp),
                loss_dtype=str(loss.dtype),
                loss=loss.asnumpy().astype(np.float32))


def test_bfloat16_bert_predicts_and_trains_like_jax(jax_amp_model):
    ref = jax_amp_model
    noise = [_rel(b, f) for b, f in zip(ref["bf16"], ref["f32"])]
    assert max(noise) <= AMP_TOL / 2, noise
    port = amp.convert_block(BERTModel(dropout=0.0, **CFG), "bfloat16")
    params_from_jax(ref["weights"], port)
    assert port.word_embed.weight.dtype == torch.bfloat16
    assert port.embed_ln.gamma.dtype == torch.float32
    tokens, types, valid = (torch.from_numpy(a) for a in _inputs())
    port.eval()
    with torch.inference_mode():
        got = port(tokens, types, valid)
    for g, w in zip(got, ref["bf16"]):
        assert g.dtype == torch.bfloat16
        err = _rel(g.float().numpy(), w)
        assert err <= AMP_TOL, (err, noise)
    port.train()
    y_mlm, y_nsp = (torch.from_numpy(a) for a in ref["labels"])
    with autograd.record():
        mlm, nsp = port(tokens, types, valid)
        loss = _pretraining_loss(SoftmaxCrossEntropyLoss(), mlm, nsp, y_mlm,
                                 y_nsp)
    assert str(loss.dtype).replace("torch.", "") == ref["loss_dtype"]
    np.testing.assert_allclose(loss.detach().float().numpy(), ref["loss"],
                               rtol=AMP_TOL)



LAMB_UPDATE_TOL = 5e-2


def _masters(trainer_states, weights):
    """Each parameter's float32 master where the state holds one (a
    bfloat16 weight under ``multi_precision``), else the weight itself,
    as numpy."""
    out = []
    for i, w in enumerate(weights):
        st = trainer_states[i]
        if isinstance(st[1], tuple):
            w = st[0]
        w = w.data if hasattr(w, "ctx") else w
        out.append(np.array(w, np.float32) if not isinstance(
            w, torch.Tensor) else w.detach().float().numpy().copy())
    return out


def test_bfloat16_lamb_multi_precision_steps_match_jax():
    """Three steps of the BERT pretraining recipe in bfloat16: the model
    converted by ``amp.convert_block``, LAMB with ``multi_precision``
    (float32 masters), a PolyScheduler with 2 warm-up steps, weight decay
    0.01 with ``wd_mult = 0`` on LayerNorm parameters and biases.  The
    JAX model is hybridized (its eager tape does not differentiate
    ``NDArray`` indexing; ``tests/test_torch_training.py``).

    Held: the learning rates equal; each step's loss, and the
    predict-mode logits after the last step, within AMP_TOL of JAX's;
    the weights' dtypes equal (bfloat16, LayerNorm float32).  The update
    of every float32 master (or float32 weight) on the elements whose
    JAX gradient was above 0.1 of its tensor's largest at every step so
    far within LAMB_UPDATE_TOL of the JAX step's largest move (a skipped
    or halved update is off by 0.5 or more; 1.4e-2 was the largest over
    the three steps when the bound was set).  Elsewhere a gradient at bfloat16's noise
    may take either sign, and the first LAMB steps move an element by
    up to lr·ratio either way; there each master is held within twice
    the sum of the JAX steps' largest moves."""
    from incubator_mxnet_tpu.optimizer.lr_scheduler import (
        PolyScheduler as JaxPoly)

    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.optimizer.lr_scheduler import PolyScheduler

    tokens, types, valid = _inputs()
    rng = np.random.default_rng(2)
    y_mlm = rng.integers(0, CFG["vocab_size"], tokens.size).astype(np.int32)
    y_nsp = rng.integers(0, 2, tokens.shape[0]).astype(np.int32)
    opt = {"learning_rate": 1e-2, "multi_precision": True, "wd": 0.01}
    sched = dict(max_update=10, base_lr=1e-2, pwr=1, warmup_steps=2)

    mx.random.seed(0)
    jnet = JaxBERT(dropout=0.0, **CFG)
    jnet.initialize()
    jax_amp.convert_block(jnet, "bfloat16")
    jnet.hybridize()
    port = amp.convert_block(BERTModel(dropout=0.0, **CFG), "bfloat16")
    params_from_jax({k: np.asarray(p.data().data)
                     for k, p in jnet.collect_params().items()}, port)
    for net in (jnet, port):
        for k, p in net.collect_params().items():
            if k.endswith(("gamma", "beta", "bias")):
                p.wd_mult = 0.0
    jtrainer = jax_gluon.Trainer(jnet.collect_params(), "lamb",
                                 dict(opt, lr_scheduler=JaxPoly(**sched)))
    trainer = Trainer(port.collect_params(), "lamb",
                      dict(opt, lr_scheduler=PolyScheduler(**sched)))
    jargs = (nd.array(tokens, dtype="int32"), nd.array(types, dtype="int32"),
             nd.array(valid, dtype="int32"))
    args = [torch.from_numpy(a) for a in (tokens, types, valid)]
    ce, jce = SoftmaxCrossEntropyLoss(), jax_gluon.loss.SoftmaxCrossEntropyLoss()
    names = list(port.collect_params())
    jparams = list(jnet.collect_params().values())
    pparams = list(port.collect_params().values())
    start = [np.asarray(p.data().data).astype(np.float32) for p in jparams]
    before, jbefore = start, start
    lrs, steady, moved = [], None, [0.0] * len(names)
    for step in range(3):
        with jax_autograd.record():
            jmlm, jnsp = jnet(*jargs)
            jloss = _pretraining_loss(jce, jmlm, jnsp, nd.array(y_mlm),
                                      nd.array(y_nsp))
        jloss.backward()
        jgrads = [np.abs(p.grad().asnumpy().astype(np.float32))
                  for p in jparams]
        jtrainer.step(tokens.shape[0])
        with autograd.record():
            mlm, nsp = port(*args)
            loss = _pretraining_loss(ce, mlm, nsp, torch.from_numpy(y_mlm),
                                     torch.from_numpy(y_nsp))
        autograd.backward(loss)
        trainer.step(tokens.shape[0])
        np.testing.assert_allclose(loss.detach().float().numpy(),
                                   jloss.asnumpy().astype(np.float32),
                                   rtol=AMP_TOL, err_msg=f"step {step}")
        assert trainer.learning_rate == jtrainer.learning_rate
        lrs.append(trainer.learning_rate)
        large = [g > 0.1 * g.max() for g in jgrads]
        steady = large if steady is None else [
            a & b for a, b in zip(steady, large)]
        after = _masters(trainer._updater.states, pparams)
        jafter = _masters(jtrainer._updaters[0].states,
                          [p.data() for p in jparams])
        for i, k in enumerate(names):
            assert pparams[i].dtype == {
                "bfloat16": torch.bfloat16, "float32": torch.float32}[
                    str(jparams[i].data().dtype)], k
            dj = jafter[i] - jbefore[i]
            dp = after[i] - before[i]
            top = np.abs(dj).max()
            moved[i] += top
            if steady[i].any():
                err = np.abs(dp - dj)[steady[i]].max()
                assert err <= LAMB_UPDATE_TOL * top, (k, step, err / top)
            assert np.abs(after[i] - jafter[i]).max() <= 2 * moved[i], k
        before, jbefore = after, jafter
    assert lrs == [0.005, 0.01, 0.00875]
    assert sum(int(m.sum()) for m in steady) > 1000
    port.eval()
    with torch.inference_mode():
        got = port(*args)
    want = [o.asnumpy().astype(np.float32) for o in jnet(*jargs)]
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), w) <= AMP_TOL
