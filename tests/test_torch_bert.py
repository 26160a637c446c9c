"""BERT of the PyTorch port against the JAX package's, on the CPU.

A small BERT is built and initialised in JAX, its weights carried over
with ``convert.params_from_jax``, and both forwards compared on the
same numpy inputs.  Tolerance float32 rtol=atol=1e-4: two layers of
matrix products summed in another order.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT

from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.models.bert import BERTModel

CFG = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
           num_heads=4, max_length=32)
TOL = dict(rtol=1e-4, atol=1e-4)


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
