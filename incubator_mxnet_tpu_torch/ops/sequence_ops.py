"""Sequence ops and the fused RNN (counterpart of
``incubator_mxnet_tpu/ops/sequence_ops.py``).

:func:`fused_rnn` is the reference's cuDNN-backed ``RNN`` operator
(``src/operator/rnn-inl.h``).  The JAX package runs it as a ``lax.scan``
that XLA generates, no Pallas kernel; on the card the port hands it to
PyTorch's own RNN op (``torch._VF.lstm``/``gru``/``rnn_tanh``/
``rnn_relu``, the call ``nn.LSTM`` makes), which runs cuDNN's RNN, the
op the reference used.  The weights stay in the JAX package's one flat
vector: the op cuts it into views (no copy), so autograd's gradient
lands in that one tensor, in that layout.  cuDNN wants its own layout
(each layer's ``w_ih, w_hh, b_ih, b_hh`` side by side), so on the card
it copies the views into its own buffer on every call; that copy keeps
checkpoints and ``params_from_jax`` on the JAX layout.

:func:`fused_rnn_reference` is the plain version: the JAX scan written
as a loop over time, cell by cell.  The tests and ``chip_smoke.py``
hold the op against it; no path of the port calls it.
"""
from __future__ import annotations

import torch

from ..amp.amp import cast_args

__all__ = ["sequence_mask", "sequence_last", "sequence_reverse",
           "fused_rnn", "fused_rnn_reference", "rnn_param_size"]

# gates a cell of each mode computes (rows of its weights per unit); the
# modes are also the names of PyTorch's RNN ops in torch._VF
_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _time_mask(steps, sequence_length, axis, ndim):
    """``(T, B)`` (axis 0) or ``(B, T)`` mask of the steps within each
    sequence, with trailing axes of length 1 up to ``ndim``."""
    t = torch.arange(steps, device=sequence_length.device)
    if axis == 0:
        mask = t[:, None] < sequence_length[None, :]
    else:
        mask = t[None, :] < sequence_length[:, None]
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def sequence_mask(data, sequence_length, use_sequence_length=True, value=0.0,
                  axis=0):
    """``data`` with every step past its sequence's length set to
    ``value``; the time axis is ``axis`` (0: ``(T, B, ...)``, 1:
    ``(B, T, ...)``)."""
    if not use_sequence_length:
        return data.clone()
    mask = _time_mask(data.shape[axis], sequence_length, axis, data.dim())
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


def sequence_last(data, sequence_length, use_sequence_length=True, axis=0):
    """Each sequence's last valid step: ``(B, ...)``."""
    if not use_sequence_length:
        return data.select(axis, -1)
    moved = data.movedim(axis, 0)
    last = sequence_length.long() - 1
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


def sequence_reverse(data, sequence_length, use_sequence_length=True,
                     axis=0):
    """Each sequence reversed within its length; the steps past it stay
    where they are."""
    moved = data.movedim(axis, 0)
    if not use_sequence_length:
        return moved.flip(0).movedim(0, axis)
    steps = moved.shape[0]
    t = torch.arange(steps, device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    src = torch.where(t < lens, lens - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (moved.dim() - 2))
    return moved.gather(0, src.expand_as(moved)).movedim(0, axis)


def rnn_param_size(input_size, state_size, num_layers, mode,
                   bidirectional=False):
    """Length of the flat parameter vector (reference
    ``GetRnnParamSize``): every layer's and direction's ``wx (ng·H,
    in)`` and ``wh (ng·H, H)``, then their ``bx`` and ``bh (ng·H,)``."""
    ng, h = _NGATES[mode], state_size
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_dim = input_size if layer == 0 else h * d
        size += d * ng * h * (in_dim + h) + d * 2 * ng * h
    return size


def _unpack(params, input_size, h, num_layers, mode, d):
    """Views of the flat ``params`` → ``[[(wx, wh, bx, bh)] per
    direction] per layer``, in the JAX layout: all weights (layer by
    layer, direction by direction, wx then wh), then all biases in the
    same order.  One ``split`` makes the views, so the backward writes
    the flat gradient in one pass."""
    want = rnn_param_size(input_size, h, num_layers, mode, d == 2)
    if params.dim() != 1 or params.numel() != want:
        raise ValueError(f"fused_rnn: params of shape {tuple(params.shape)}, "
                         f"want ({want},) for input {input_size}, state "
                         f"{h}, {num_layers} layer(s), {mode}, {d} "
                         "direction(s)")
    ng = _NGATES[mode]
    shapes = []
    for layer in range(num_layers):
        in_dim = input_size if layer == 0 else h * d
        shapes += [(ng * h, in_dim), (ng * h, h)] * d
    shapes += [(ng * h,)] * (2 * d * num_layers)
    pieces = params.split([int(torch.Size(s).numel()) for s in shapes])
    views = [p.view(s) for p, s in zip(pieces, shapes)]
    weights, biases = views[:2 * d * num_layers], views[2 * d * num_layers:]
    return [[(weights[2 * (layer * d + k)], weights[2 * (layer * d + k) + 1],
              biases[2 * (layer * d + k)], biases[2 * (layer * d + k) + 1])
             for k in range(d)] for layer in range(num_layers)]


def fused_rnn(data, params, state, state_cell=None, *, state_size,
              num_layers=1, mode="lstm", bidirectional=False, p=0.0):
    """Multi-layer RNN over ``data (T, B, I)`` → ``(out, hN, cN)`` for
    ``"lstm"``, ``(out, hN)`` otherwise; ``out`` is ``(T, B, D·H)`` and
    the states ``(num_layers·D, B, H)``.  ``params`` is the flat vector
    of :func:`rnn_param_size`.  Gate orders are the JAX package's and
    PyTorch's alike: LSTM i, f, g, o; GRU r, z, n with ``r`` applied to
    ``h·W_hn + b_hn``.

    ``p`` is taken and not applied, as the JAX op takes and ignores it:
    no dropout between layers.  A CPU tensor runs PyTorch's CPU RNN; a
    CUDA tensor runs cuDNN's, or raises where cuDNN does not take it
    (cuDNN off, or a dtype it lacks, such as bfloat16)."""
    del p   # the JAX op applies no dropout between layers
    if mode not in _NGATES:
        raise ValueError(f"fused_rnn: unknown mode {mode!r}; have "
                         f"{sorted(_NGATES)}")
    if (mode == "lstm") != (state_cell is not None):
        raise ValueError("fused_rnn: state_cell is required for 'lstm' "
                         "and taken by no other mode")
    data, params, state, state_cell = cast_args("RNN", data, params, state,
                                                state_cell)
    if data.is_cuda and not torch.backends.cudnn.is_acceptable(data):
        raise RuntimeError(
            f"fused_rnn: cuDNN does not take this input ({data.dtype}, "
            f"cudnn.enabled={torch.backends.cudnn.enabled}); the port "
            "runs the fused RNN on the card through cuDNN only")
    d = 2 if bidirectional else 1
    layers = _unpack(params, data.shape[-1], state_size, num_layers, mode, d)
    flat = [w for dirs in layers for ws in dirs for w in ws]
    hx = (state, state_cell) if mode == "lstm" else state
    # (input, hx, weights, has_biases, num_layers, dropout, train,
    # bidirectional, batch_first); train keeps what the backward needs
    out = getattr(torch._VF, mode)(data, hx, flat, True, num_layers, 0.0,
                                   torch.is_grad_enabled(), bidirectional,
                                   False)
    return tuple(out)


def _cell(mode, x, h, c, wx, wh, bx, bh):
    """One step of one direction of one layer, as the JAX cells
    (``_lstm_cell``, ``_gru_cell``, ``_rnn_cell``) compute it."""
    if mode == "lstm":
        gates = x @ wx.T + h @ wh.T + (bx + bh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        xr, xz, xn = (x @ wx.T + bx).chunk(3, dim=-1)
        hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, None
    y = x @ wx.T + h @ wh.T + (bx + bh)
    return (torch.tanh(y) if mode == "rnn_tanh" else torch.relu(y)), None


def fused_rnn_reference(data, params, state, state_cell=None, *, state_size,
                        num_layers=1, mode="lstm", bidirectional=False,
                        p=0.0):
    """Plain version of :func:`fused_rnn`: the JAX op's scan as a loop
    over time, layer by layer, direction by direction (the reverse
    direction reads the sequence backwards and writes its outputs back
    in time order)."""
    del p
    d = 2 if bidirectional else 1
    layers = _unpack(params, data.shape[-1], state_size, num_layers, mode, d)
    out = data
    h_fin, c_fin = [], []
    for layer, dirs in enumerate(layers):
        dir_outs = []
        for k, ws in enumerate(dirs):
            idx = layer * d + k
            h = state[idx]
            c = state_cell[idx] if mode == "lstm" else None
            steps = range(out.shape[0])
            ys = [None] * out.shape[0]
            for t in (steps if k == 0 else reversed(steps)):
                h, c = _cell(mode, out[t], h, c, *ws)
                ys[t] = h
            h_fin.append(h)
            c_fin.append(c)
            dir_outs.append(torch.stack(ys))
        out = torch.cat(dir_outs, dim=-1) if d == 2 else dir_outs[0]
    if mode == "lstm":
        return out, torch.stack(h_fin), torch.stack(c_fin)
    return out, torch.stack(h_fin)
