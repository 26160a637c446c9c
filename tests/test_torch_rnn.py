"""The port's fused RNN, recurrent layers and cells, sequence ops and
``clip_global_norm`` against the JAX package's, on the CPU.

Inputs and weights are numpy arrays from a seed, handed to both
packages; layers and cells carry the JAX weights across with
``params_from_jax``.  ``fused_rnn`` runs here through PyTorch's own RNN
op, the call that runs cuDNN's RNN on the card, and
``fused_rnn_reference`` (the JAX scan written as a loop) beside it.

Tolerances (float32): outputs and states 1e-5 absolute; gradients
max|d| <= 1e-4 of the largest |JAX| value of their tensor (the same
products summed in another order; a probe measured 3.3e-7 and 4.6e-7).
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jax_autograd
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import rnn as jax_rnn
from incubator_mxnet_tpu.gluon import utils as jax_utils
from incubator_mxnet_tpu.ops import sequence_ops as jax_seq

from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.context import resolve_device
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.error import DeviceUnavailableError
from incubator_mxnet_tpu_torch.gluon import rnn, utils
from incubator_mxnet_tpu_torch.ops import sequence_ops as seq

ATOL, GRAD_RTOL = 1e-5, 1e-4
T, B, I, H = 5, 3, 7, 6
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
_JAX_GRADS = {}


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= atol, (what, err)


def _close_grad(got, want, what=""):
    want = np.asarray(want)
    _close(got, want, GRAD_RTOL * max(np.abs(want).max(), 1e-30), what)


def _jax_value_and_grad(mode, layers, bidirectional, given_state):
    """The JAX op's outputs and the gradients of the sum of every
    output (out, hN and, for LSTM, cN) w.r.t. data, params and the
    states.  One jitted function per mode holds all four {1, 2} layers
    x {1, 2} directions (one compile instead of four); its results for
    each state are kept for the tests of that mode."""
    configs = list(itertools.product([1, 2], [False, True]))
    if mode not in _JAX_GRADS:
        def one(layers, bidirectional, x, p, h0, c0):
            def f(x, p, h0, c0):
                outs = jax_seq.fused_rnn.fn(
                    x, p, h0, c0 if mode == "lstm" else None, state_size=H,
                    num_layers=layers, mode=mode, bidirectional=bidirectional)
                return sum(jnp.sum(o) for o in outs), outs
            return jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                      has_aux=True)(x, p, h0, c0)

        _JAX_GRADS[mode] = jax.jit(lambda inputs: [
            one(*c, *a) for c, a in zip(configs, inputs)])
    key = (mode, given_state)
    if key not in _JAX_GRADS:
        inputs = [_op_inputs(mode, *c, given_state) for c in configs]
        _JAX_GRADS[key] = dict(zip(configs, _JAX_GRADS[mode](inputs)))
    return _JAX_GRADS[key][(layers, bidirectional)]


def _op_inputs(mode, layers, bidirectional, given_state):
    rs = np.random.RandomState(0)
    d = 2 if bidirectional else 1
    n = seq.rnn_param_size(I, H, layers, mode, bidirectional)
    x = rs.randn(T, B, I).astype(np.float32)
    p = (rs.randn(n) * 0.3).astype(np.float32)
    h0 = rs.randn(layers * d, B, H).astype(np.float32)
    c0 = rs.randn(layers * d, B, H).astype(np.float32)
    if not given_state:
        h0, c0 = np.zeros_like(h0), np.zeros_like(c0)
    return x, p, h0, c0


@pytest.mark.parametrize("fn", [seq.fused_rnn, seq.fused_rnn_reference],
                         ids=["fused_rnn", "reference"])
@pytest.mark.parametrize("given_state", [True, False],
                         ids=["state", "zero_state"])
@pytest.mark.parametrize("mode,layers,bidirectional", list(
    itertools.product(MODES, [1, 2], [False, True])))
def test_fused_rnn_matches_jax(mode, layers, bidirectional, given_state, fn):
    """Forward (out, hN, cN) and the gradients of the sum of the outputs
    w.r.t. data, the flat parameter and the states, for every mode x
    {1, 2} layers x {1, 2} directions.  The flat parameter's gradient
    is one tensor of its shape, in the JAX layout."""
    x, p, h0, c0 = _op_inputs(mode, layers, bidirectional, given_state)
    (_, jouts), jgrads = _jax_value_and_grad(mode, layers, bidirectional,
                                             given_state)
    tx, tp, th, tc = (torch.tensor(a, requires_grad=True)
                      for a in (x, p, h0, c0))
    outs = fn(tx, tp, th, tc if mode == "lstm" else None, state_size=H,
              num_layers=layers, mode=mode, bidirectional=bidirectional)
    assert len(outs) == (3 if mode == "lstm" else 2)
    for name, got, want in zip(("out", "hN", "cN"), outs, jouts):
        _close(got, want, what=name)
    sum(o.sum() for o in outs).backward()
    assert tp.grad.shape == tp.shape
    grads = [("data", tx.grad), ("params", tp.grad), ("h0", th.grad)]
    if mode == "lstm":
        grads.append(("c0", tc.grad))
    for (name, got), want in zip(grads, jgrads):
        _close_grad(got, want, name)


def test_fused_rnn_unpacks_views_of_the_flat_parameter():
    """The weights handed to PyTorch's op are views into the one flat
    parameter (no copy), in the JAX layout: all weights, then all
    biases; layer 1's input width is H·D."""
    n = seq.rnn_param_size(I, H, 2, "gru", True)
    p = torch.arange(n, dtype=torch.float32)
    layers = seq._unpack(p, I, H, 2, "gru", 2)
    flat = [w for dirs in layers for ws in dirs for w in ws]
    assert all(w.untyped_storage().data_ptr() == p.untyped_storage()
               .data_ptr() for w in flat)
    wx, wh, bx, bh = layers[1][1]
    assert wx.shape == (3 * H, 2 * H) and wh.shape == (3 * H, H)
    weights = 2 * 3 * H * (I + H) + 2 * 3 * H * (2 * H + H)
    assert layers[0][0][2][0].item() == weights      # first bias
    assert bh[-1].item() == n - 1                    # the last entry
    assert layers[0][1][0][0, 0].item() == 3 * H * (I + H)


def test_fused_rnn_rejects_a_wrong_parameter_length():
    x = torch.zeros(T, B, I)
    h = torch.zeros(1, B, H)
    with pytest.raises(ValueError, match="want"):
        seq.fused_rnn(x, torch.zeros(10), h, h, state_size=H)
    with pytest.raises(ValueError, match="state_cell"):
        seq.fused_rnn(x, torch.zeros(seq.rnn_param_size(I, H, 1, "gru")), h,
                      h, state_size=H, mode="gru")


@pytest.mark.parametrize("layer,mode", [(jax_rnn.RNN, "rnn_relu"),
                                        (jax_rnn.LSTM, "lstm"),
                                        (jax_rnn.GRU, "gru")])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_layer_matches_jax(layer, mode, layout, bidirectional):
    """Each layer in both layouts, deferred ``input_size``: outputs
    without a state, then outputs and final states from a given state;
    the port's deferred ``params_flat`` takes its length from the JAX
    array."""
    rs = np.random.RandomState(1)
    x = rs.randn(*((T, B, I) if layout == "TNC" else (B, T, I))).astype(
        np.float32)
    mx.random.seed(0)
    jnet = layer(H, 2, layout=layout, bidirectional=bidirectional)
    jnet.initialize()
    jout = jnet(nd.array(x)).asnumpy()
    jstates = jnet.begin_state(B)
    jstates = [nd.array(rs.randn(*s.shape).astype(np.float32))
               for s in jstates]
    jout2, jnew = jnet(nd.array(x), jstates)
    port = getattr(rnn, layer.__name__)(H, 2, layout=layout,
                                        bidirectional=bidirectional)
    port.initialize(device="cpu")
    params_from_jax({k: v.data().asnumpy()
                     for k, v in jnet.collect_params().items()}, port)
    assert port.params_flat.shape == (
        seq.rnn_param_size(I, H, 2, mode, bidirectional),)
    _close(port(torch.from_numpy(x)), jout, what="out")
    out2, new = port(torch.from_numpy(x),
                     [torch.tensor(s.asnumpy()) for s in jstates])
    _close(out2, jout2.asnumpy(), what="out with state")
    assert len(new) == len(jnew) == (2 if mode == "lstm" else 1)
    for got, want in zip(new, jnew):
        _close(got, want.asnumpy(), what="state")


def test_layer_state_info_and_begin_state():
    lstm = rnn.LSTM(H, 3, bidirectional=True)
    jlstm = jax_rnn.LSTM(H, 3, bidirectional=True)
    assert lstm.state_info(4) == jlstm.state_info(4)
    gru = rnn.GRU(H, 2)
    assert gru.state_info(4) == jax_rnn.GRU(H, 2).state_info(4)
    states = lstm.begin_state(4, device="cpu", dtype="float64")
    assert [tuple(s.shape) for s in states] == [(6, 4, H), (6, 4, H)]
    assert all(s.dtype == torch.float64 and not s.any() for s in states)
    ones = gru.begin_state(2, func=torch.ones, device="cpu")
    assert len(ones) == 1 and ones[0].shape == (2, 2, H) and ones[0].all()


def test_layer_begin_state_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        rnn.LSTM(H).begin_state(2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_layer_deferred_init_and_xavier_draw():
    """``params_flat`` waits for the first batch, then is drawn by
    Xavier over its 1-D shape, biases included: every entry within
    ±sqrt(3/N), spread over the whole range; another generator draws
    other values."""
    lstm = rnn.LSTM(H, 2)
    lstm.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(lstm.params_flat, torch.nn.UninitializedParameter)
    lstm(torch.zeros(T, B, I))
    n = seq.rnn_param_size(I, H, 2, "lstm")
    p = lstm.params_flat.detach()
    assert p.shape == (n,)
    bound = (3.0 / n) ** 0.5
    assert p.abs().max() <= bound and p.abs().max() > 0.95 * bound
    biases = p[-2 * 2 * 4 * H:]
    assert biases.abs().max() > 0.5 * bound          # biases are drawn
    assert abs(p.mean().item()) < 0.05 * bound
    other = rnn.LSTM(H, 2, input_size=I)
    other.initialize(device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other.params_flat.detach(), p)


_CELLS = {
    "rnn_tanh": lambda m: m.RNNCell(H),
    "rnn_relu": lambda m: m.RNNCell(H, activation="relu"),
    "lstm": lambda m: m.LSTMCell(H),
    "gru": lambda m: m.GRUCell(H),
    "sequential": lambda m: _sequential(m),
    "residual": lambda m: m.ResidualCell(m.GRUCell(I)),
    "zoneout_predict": lambda m: m.ZoneoutCell(m.LSTMCell(H), 0.5, 0.5),
    "dropout_predict": lambda m: _dropout_stack(m),
}


def _sequential(m):
    cell = m.SequentialRNNCell()
    cell.add(m.LSTMCell(H))
    cell.add(m.GRUCell(4))
    return cell


def _dropout_stack(m):
    cell = m.SequentialRNNCell()
    cell.add(m.RNNCell(H))
    cell.add(m.DropoutCell(0.5))
    return cell


def _carry(jcell, cell):
    params_from_jax({k: v.data().asnumpy()
                     for k, v in jcell.collect_params().items()}, cell)


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "list"])
@pytest.mark.parametrize("kind", sorted(_CELLS))
def test_cell_unroll_matches_jax(kind, merge):
    """Each cell unrolled over T steps (NTC), weights deferred on both
    sides; the merged outputs or the list of steps, and the final
    states.  Zoneout and dropout run in predict mode, where they pass
    values through."""
    rs = np.random.RandomState(2)
    x = rs.randn(B, T, I).astype(np.float32)
    mx.random.seed(0)
    jcell = _CELLS[kind](jax_rnn)
    jcell.initialize()
    jout, jstates = jcell.unroll(T, nd.array(x), layout="NTC",
                                 merge_outputs=merge)
    cell = _CELLS[kind](rnn)
    cell.initialize(device="cpu")
    _carry(jcell, cell)                 # materialises the deferred weights
    out, states = cell.unroll(T, torch.from_numpy(x), layout="NTC",
                              merge_outputs=merge)
    if merge:
        _close(out, jout.asnumpy(), what="outputs")
    else:
        assert isinstance(out, list) and len(out) == len(jout) == T
        for got, want in zip(out, jout):
            _close(got, want.asnumpy(), what="step output")
    assert len(states) == len(jstates)
    for got, want in zip(states, jstates):
        _close(got, want.asnumpy(), what="state")


def test_cell_step_and_gradients_match_jax():
    """One LSTMCell step, TNC unroll with a given state, and the
    gradients of the outputs' sum w.r.t. every weight."""
    rs = np.random.RandomState(3)
    x = rs.randn(T, B, I).astype(np.float32)
    h0, c0 = (rs.randn(B, H).astype(np.float32) for _ in range(2))
    mx.random.seed(0)
    jcell = jax_rnn.LSTMCell(H, input_size=I)
    jcell.initialize()
    jstate = [nd.array(h0), nd.array(c0)]
    with jax_autograd.record():
        jout, _ = jcell.unroll(T, nd.array(x), jstate, layout="TNC")
        jloss = jout.sum()
    jloss.backward()
    cell = rnn.LSTMCell(H, input_size=I)
    cell.initialize(device="cpu")
    _carry(jcell, cell)
    with autograd.record():
        out, _ = cell.unroll(T, torch.from_numpy(x),
                             [torch.from_numpy(h0), torch.from_numpy(c0)],
                             layout="TNC")
        loss = out.sum()
    autograd.backward(loss)
    _close(out, jout.asnumpy(), what="outputs")
    for name, p in cell.collect_params().items():
        _close_grad(p.grad, jcell.collect_params()[name].grad().asnumpy(),
                    name)


def test_bidirectional_cell_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(B, T, I).astype(np.float32)
    mx.random.seed(0)
    jcell = jax_rnn.BidirectionalCell(jax_rnn.LSTMCell(H),
                                      jax_rnn.GRUCell(4))
    jcell.initialize()
    jout, jstates = jcell.unroll(T, nd.array(x), layout="NTC")
    cell = rnn.BidirectionalCell(rnn.LSTMCell(H), rnn.GRUCell(4))
    cell.initialize(device="cpu")
    _carry(jcell, cell)
    out, states = cell.unroll(T, torch.from_numpy(x), layout="NTC")
    assert out.shape == (B, T, H + 4)
    _close(out, jout.asnumpy(), what="outputs")
    for got, want in zip(states, jstates):
        _close(got, want.asnumpy(), what="state")
    with pytest.raises(NotImplementedError):
        cell(torch.from_numpy(x[:, 0]), states)
    with pytest.raises(NotImplementedError, match="valid_length"):
        cell.unroll(T, torch.from_numpy(x), valid_length=torch.ones(B))


def test_cell_state_info_matches_jax():
    for make in _CELLS.values():
        assert make(rnn).state_info(4) == make(jax_rnn).state_info(4)
    assert rnn.HybridRecurrentCell is rnn.RecurrentCell
    assert rnn.HybridSequentialRNNCell is rnn.SequentialRNNCell


def test_dropout_cell_properties():
    """Train mode: about ``rate`` of the entries zeroed, the rest scaled
    by 1/(1 - rate); a seeded generator repeats its mask; predict mode
    passes the input through."""
    cell = rnn.DropoutCell(0.3)
    x = torch.ones(200, 100)
    assert torch.equal(cell(x, [])[0], x)
    cell.generator = torch.Generator().manual_seed(0)
    with autograd.record():
        y, states = cell(x, [])
    assert states == []
    zeros = (y == 0).float().mean().item()
    assert abs(zeros - 0.3) < 0.02, zeros
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / 0.7))
    cell.generator = torch.Generator().manual_seed(0)
    with autograd.record():
        assert torch.equal(cell(x, [])[0], y)


def test_zoneout_cell_properties():
    """Train mode: each output element is the new value or the previous
    step's, about ``zoneout_outputs`` of them the previous; each state
    element the new or the old value (one mask decides), about
    ``zoneout_states`` of them the old."""
    base = rnn.RNNCell(50, input_size=8)
    base.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    cell = rnn.ZoneoutCell(base, zoneout_outputs=0.4, zoneout_states=0.25)
    cell.generator = torch.Generator().manual_seed(0)
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    states = [torch.randn(64, 50, generator=torch.Generator().manual_seed(2))]
    cell.begin_state(64, device="cpu")
    with autograd.record():
        new, _ = base(x, states)
        out, st = cell(x, states)
    kept_old = (out == 0) & (new != 0)      # previous output: zeros
    assert torch.all((out == new) | kept_old)
    assert abs(kept_old.float().mean().item() - 0.4) < 0.05
    old_state = (st[0] == states[0]) & (st[0] != new)
    assert torch.all((st[0] == new) | old_state)
    assert abs(old_state.float().mean().item() - 0.25) < 0.05


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_ops_match_jax(axis):
    """``sequence_mask``, ``sequence_last`` and ``sequence_reverse`` on
    both time axes, with and without lengths (one sequence of length
    T, one of 1)."""
    rs = np.random.RandomState(5)
    shape = (T, B, 4) if axis == 0 else (B, T, 4)
    x = rs.randn(*shape).astype(np.float32)
    lens = np.array([T, 1, 3], np.int32)
    jx, jl = jnp.asarray(x), jnp.asarray(lens)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lens)
    for use in (True, False):
        _close(seq.sequence_mask(tx, tl, use, value=-7.0, axis=axis),
               jax_seq.sequence_mask.fn(jx, jl, use, value=-7.0, axis=axis),
               what="mask")
        _close(seq.sequence_last(tx, tl, use, axis=axis),
               jax_seq.sequence_last.fn(jx, jl, use, axis=axis), what="last")
        _close(seq.sequence_reverse(tx, tl, use, axis=axis),
               jax_seq.sequence_reverse.fn(jx, jl, use, axis=axis),
               what="reverse")


@pytest.mark.parametrize("max_norm,check", [(1.0, True), (100.0, True),
                                            (0.5, False)])
def test_clip_global_norm_matches_jax(max_norm, check):
    rs = np.random.RandomState(6)
    arrays = [rs.randn(*s).astype(np.float32) for s in ((5, 4), (7,), (3,))]
    jarrays = [nd.array(a) for a in arrays]
    jnorm = jax_utils.clip_global_norm(jarrays, max_norm, check)
    tarrays = [torch.from_numpy(a.copy()) for a in arrays]
    norm = utils.clip_global_norm(tarrays, max_norm, check)
    if check:
        assert isinstance(norm, float)
        assert abs(norm - jnorm) <= 1e-6 * jnorm
    else:
        assert isinstance(norm, torch.Tensor) and norm.dim() == 0
        _close(norm, jnorm.asnumpy(), what="norm")
    for got, want in zip(tarrays, jarrays):
        _close(got, want.asnumpy(), what="clipped")
    total = np.sqrt(sum((t.numpy() ** 2).sum() for t in tarrays))
    assert total <= max_norm * (1 + 1e-6)


def test_split_data_matches_jax():
    x = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    got = utils.split_data(torch.from_numpy(x), 3, even_split=False)
    want = jax_utils.split_data(nd.array(x), 3, even_split=False)
    assert [tuple(g.shape) for g in got] == [(2, 2), (2, 2), (3, 2)]
    for g, w in zip(got, want):
        _close(g, w.asnumpy())
    with pytest.raises(ValueError, match="divisible"):
        utils.split_data(torch.from_numpy(x), 3)
    cols = utils.split_data(torch.from_numpy(x[:6]), 2, batch_axis=1)
    assert [tuple(c.shape) for c in cols] == [(6, 1), (6, 1)]
