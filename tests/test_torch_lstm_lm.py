"""The port's LSTM language model (``models/lstm_lm.py``) against the JAX
package's, on the CPU, at a small size: vocab 30, embed 16, hidden 32,
2 layers, T=6, B=4.

The JAX model's weights are carried across with ``params_from_jax``
(``encoder.weight``, ``rnn.params_flat``, ``decoder.weight``,
``decoder.bias``); tokens come from numpy.  The port's LSTM runs
PyTorch's RNN op, the call that runs cuDNN's on the card.

Tolerances (float32): logits and states 1e-5 absolute; the loss 1e-5
relative; every gradient max|d| <= 1e-4 of its tensor's largest |JAX|
value; after each Adam step (lr 1e-2) the update of every weight whose
gradient was above 1e-2 of its tensor's largest at every step so far
within 1e-2·lr, and every weight within 2·lr (Adam moves a weight by
about lr·g/(|g| + eps), so a gradient at rounding level may move it by
another fraction of lr).  Dropout's random stream differs between the
packages, so it is held by its properties.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models.lstm_lm import (
    LSTMLanguageModel as JaxLSTMLanguageModel)

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                               params_from_jax,
                                               params_to_numpy)
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models import LSTMLanguageModel
from incubator_mxnet_tpu_torch.ops import sequence_ops

V, E, H, L, T, B = 30, 16, 32, 2, 6, 4
LR = 1e-2
NAMES = ["encoder.weight", "rnn.params_flat", "decoder.weight",
         "decoder.bias"]


def _batch(seed=4):
    """word_lm's layout: time-major inputs (T, B), targets the next
    token, flattened in T·B order."""
    seq = np.random.RandomState(seed).randint(0, V, (B, T + 1)).astype(
        np.int32)
    return seq[:, :-1].T.copy(), seq[:, 1:].T.reshape(-1).copy()


def _models(dropout=0.0):
    mx.random.seed(0)
    jnet = JaxLSTMLanguageModel(V, E, H, L, dropout=dropout)
    jnet.initialize()
    port = LSTMLanguageModel(V, E, H, L, dropout=dropout)
    port.initialize(device="cpu")
    params_from_jax({k: p.data().asnumpy()
                     for k, p in jnet.collect_params().items()}, port)
    return jnet, port


def _close(got, want, atol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, (what, err)


def test_parameter_names_match_jax():
    jnet, port = _models()
    assert list(port.collect_params()) == list(jnet.collect_params()) \
        == NAMES
    assert port.rnn.params_flat.shape == (
        sequence_ops.rnn_param_size(E, H, L, "lstm"),)


def test_logits_and_state_match_jax():
    """Without a state: logits (T, B, V); with a state: logits and the
    final [h, c]."""
    jnet, port = _models()
    x, _ = _batch()
    rs = np.random.RandomState(5)
    h0, c0 = (rs.randn(L, B, H).astype(np.float32) for _ in range(2))
    jout = jnet(nd.array(x)).asnumpy()
    jout2, (jh, jc) = jnet(nd.array(x), [nd.array(h0), nd.array(c0)])
    tx = torch.from_numpy(x)
    out = port(tx)
    assert out.shape == (T, B, V)
    _close(out, jout, what="logits")
    out2, (h, c) = port(tx, [torch.from_numpy(h0), torch.from_numpy(c0)])
    _close(out2, jout2.asnumpy(), what="logits with state")
    _close(h, jh.asnumpy(), what="hN")
    _close(c, jc.asnumpy(), what="cN")
    states = port.begin_state(B, device="cpu")
    assert [tuple(s.shape) for s in states] == [(L, B, H)] * 2


def _jax_step(jnet, x, y):
    loss_fn = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    with jax_autograd.record():
        loss = loss_fn(jnet(nd.array(x)).reshape((T * B, -1)),
                       nd.array(y)).mean()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()}
    return float(loss.asnumpy()), grads


def _port_step(port, x, y):
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(
            port(torch.from_numpy(x)).reshape(T * B, -1),
            torch.from_numpy(y)).mean()
    autograd.backward(loss)
    return loss.item(), grads_to_numpy(port)


def _named(jnet):
    return {k: p.data().asnumpy().copy()
            for k, p in jnet.collect_params().items()}


def test_three_adam_steps_match_jax():
    """Three Adam steps (dropout 0): the loss and every gradient at each
    step, the updates and the weights after it.  The JAX model runs
    hybridized (one compiled forward and backward)."""
    jnet, port = _models()
    jnet.hybridize()
    x, y = _batch()
    jtrainer = jax_gluon.Trainer(jnet.collect_params(), "adam",
                                 {"learning_rate": LR})
    trainer = Trainer(port.collect_params(), "adam", {"learning_rate": LR})
    steady = None
    losses = []
    for step in range(3):
        jloss, jgrads = _jax_step(jnet, x, y)
        loss, grads = _port_step(port, x, y)
        assert abs(loss - jloss) <= 1e-5 * abs(jloss), (step, loss, jloss)
        losses.append(loss)
        for k, g in grads.items():
            _close(g, jgrads[k], 1e-4 * np.abs(jgrads[k]).max(),
                   f"grad {k}, step {step}")
        large = {k: np.abs(g) > 1e-2 * np.abs(g).max()
                 for k, g in jgrads.items()}
        steady = large if steady is None else {
            k: steady[k] & large[k] for k in large}
        jbefore, before = _named(jnet), params_to_numpy(port)
        jtrainer.step(B)
        trainer.step(B)
        jafter, after = _named(jnet), params_to_numpy(port)
        for k, mask in steady.items():
            d = np.abs((after[k] - before[k]) - (jafter[k] - jbefore[k]))
            assert d[mask].max() <= 1e-2 * LR, (k, step, d[mask].max())
            assert np.abs(after[k] - jafter[k]).max() <= 2 * LR, (k, step)
    assert losses[2] < losses[0]
    assert sum(int(m.sum()) for m in steady.values()) > 1000


def test_overfits_one_batch():
    """The JAX package's ``test_lstm_lm_overfits`` on the port: Adam lr
    1e-2 on one batch until the loss falls below 0.4 of the first."""
    torch.manual_seed(0)
    net = LSTMLanguageModel(V, E, H, dropout=0.0)
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(4))
    x, y = _batch()
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    first = final = None
    for _ in range(150):
        loss, _ = _port_step(net, x, y)
        trainer.step(B)
        first = loss if first is None else first
        final = loss
        if loss < 0.4 * first:
            break
    assert final < 0.4 * first, (first, final)


def test_initial_weights_properties():
    """The embedding and decoder draw U(±0.07) (``Uniform()``), the flat
    LSTM parameter Xavier over its 1-D shape, U(±sqrt(3/N)) with the
    biases drawn too, the decoder's bias zeros; a seeded generator
    repeats the draw."""
    def build(seed):
        net = LSTMLanguageModel(V, E, H, L)
        return net.initialize(device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    net = build(0)
    p = net.rnn.params_flat.detach()
    bound = (3.0 / p.numel()) ** 0.5
    assert bound * 0.95 < p.abs().max() <= bound
    assert p[-2 * L * 4 * H:].abs().max() > 0.5 * bound
    for w in (net.encoder.weight, net.decoder.weight):
        assert 0.06 < w.abs().max().item() <= 0.07
    assert not net.decoder.bias.any()
    again = build(0)
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 again.parameters()))


def test_dropout_properties():
    """Dropout 0.5 on the embeddings and the LSTM's outputs in train mode
    only: predict mode gives the dropout-0 model's logits; train mode
    gives others, repeated by a seeded generator; the dropout layer zeroes
    about half of the entries and doubles the rest."""
    _, plain = _models(0.0)
    _, net = _models(0.5)
    x = torch.from_numpy(_batch()[0])
    torch.testing.assert_close(net(x), plain(x), rtol=0, atol=0)
    runs = []
    for _ in range(2):
        net.drop.generator = torch.Generator().manual_seed(7)
        with autograd.record():
            runs.append(net(x))
    assert torch.equal(runs[0], runs[1])
    assert (runs[0] - plain(x)).abs().max() > 1e-3
    emb = net.encoder(torch.randint(0, V, (50, 40)))
    net.drop.generator = torch.Generator().manual_seed(8)
    with autograd.record():
        dropped = net.drop(emb)
    zeros = (dropped == 0).float().mean().item()
    assert abs(zeros - 0.5) < 0.02, zeros
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], 2 * emb[kept])


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        LSTMLanguageModel(V, E, H).initialize()
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        LSTMLanguageModel(V, E, H).begin_state(B)


def test_tie_weights_raises():
    """The JAX model takes ``tie_weights`` and ignores it; the port
    refuses it rather than build an untied model."""
    with pytest.raises(NotImplementedError, match="tie_weights"):
        LSTMLanguageModel(V, E, H, tie_weights=True)
