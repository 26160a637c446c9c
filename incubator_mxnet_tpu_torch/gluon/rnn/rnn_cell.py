"""Recurrent cells (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py``; reference
``python/mxnet/gluon/rnn/rnn_cell.py``).

Cells are small blocks for recurrences of one's own; ``unroll`` runs a
Python loop over time.  The fused layers of ``rnn_layer.py`` are the
fast path.  Every cell is plain PyTorch.  ``DropoutCell`` and
``ZoneoutCell`` draw their masks from ``generator`` (a
``torch.Generator`` on the input's device) when one is set, else from
PyTorch's default generator, and only in train mode
(``autograd.is_training()``), as ``nn.Dropout`` does.
"""
from __future__ import annotations

import torch

from ... import _remat, autograd
from ... import initializer as init_mod
from ...ops import nn_ops
from ..block import HybridBlock
from .rnn_layer import begin_states

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell", "ZoneoutCell", "ModifierCell",
           "HybridRecurrentCell", "HybridSequentialRNNCell"]


class RecurrentCell(HybridBlock):
    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=torch.zeros, device=None,
                    **kwargs):
        """Zero states (or ``func``'s) of ``state_info(batch_size)`` on
        ``device`` (``cuda:0`` unless given)."""
        return begin_states(self.state_info(batch_size), func, device,
                            **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs`` → ``(outputs,
        states)``: the outputs stacked along the time axis unless
        ``merge_outputs`` is False (then a list).  ``valid_length`` is
        not ported: the JAX package takes it and ignores it."""
        if valid_length is not None:
            raise NotImplementedError("unroll: valid_length is not ported")
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = begin_state
        if states is None:
            states = self.begin_state(batch, device=inputs.device)
        outputs = []
        for t in range(length):
            out, states = self(inputs.select(axis, t), states)
            outputs.append(out)
        if merge_outputs or merge_outputs is None:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states

    def forward(self, inputs, states):
        raise NotImplementedError


class _GatedCell(RecurrentCell):
    """A cell of ``ngates`` gates: ``i2h_weight (ng·H, input_size)``
    (deferred without ``input_size``) and ``h2h_weight (ng·H, H)``,
    Xavier; ``i2h_bias`` and ``h2h_bias`` zeros."""

    _ngates = 1

    def __init__(self, hidden_size, input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        rows = self._ngates * hidden_size
        self.new_param("i2h_weight", (rows, input_size), init_mod.Xavier())
        self.new_param("h2h_weight", (rows, hidden_size), init_mod.Xavier())
        self.new_param("i2h_bias", (rows,), "zeros")
        self.new_param("h2h_bias", (rows,), "zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _i2h_h2h(self, inputs, h):
        rows = self._ngates * self._hidden_size
        self.finish_deferred_init("i2h_weight", (rows, inputs.shape[-1]))
        i2h = nn_ops.fully_connected(inputs, self.i2h_weight, self.i2h_bias,
                                     flatten=False)
        h2h = nn_ops.fully_connected(h, self.h2h_weight, self.h2h_bias,
                                     flatten=False)
        return i2h, h2h


class RNNCell(_GatedCell):
    """h' = act(x·Wᵢ + bᵢ + h·Wₕ + bₕ)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0):
        super().__init__(hidden_size, input_size)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h = self._i2h_h2h(inputs, states[0])
        out = nn_ops.activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """Gates i, f, g, o; states ``[h, c]``."""

    _ngates = 4

    def state_info(self, batch_size=0):
        (info,) = super().state_info(batch_size)
        return [info, dict(info)]

    def forward(self, inputs, states):
        i2h, h2h = self._i2h_h2h(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, dim=-1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    """Gates r, z, n, with r applied to ``h·W_hn + b_hn``."""

    _ngates = 3

    def forward(self, inputs, states):
        i2h, h2h = self._i2h_h2h(inputs, states[0])
        i2h_r, i2h_z, i2h_n = i2h.chunk(3, dim=-1)
        h2h_r, h2h_z, h2h_n = h2h.chunk(3, dim=-1)
        r = torch.sigmoid(i2h_r + h2h_r)
        z = torch.sigmoid(i2h_z + h2h_z)
        n = torch.tanh(i2h_n + r * h2h_n)
        out = (1.0 - z) * n + z * states[0]
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input; the
    states are the cells' states one after another."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size) for c in self.children()), [])

    def begin_state(self, batch_size=0, **kwargs):
        return sum((c.begin_state(batch_size, **kwargs)
                    for c in self.children()), [])

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self.children():
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(st)
        return inputs, next_states


class ModifierCell(RecurrentCell):
    """Base of cells that wrap ``base_cell`` and change what it does;
    its states are the base cell's."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class DropoutCell(RecurrentCell):
    """Dropout of rate ``rate`` on the input, in train mode; no state."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate
        self.generator = None

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate and autograd.is_training():
            inputs = nn_ops.dropout(inputs, self._rate, "training",
                                    generator=self.generator)
        return inputs, states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout (reference ``ZoneoutCell``): in train mode each element of
    the output keeps the previous step's value with probability
    ``zoneout_outputs`` and each state element its previous value with
    probability ``zoneout_states``; one mask a state decides.  (The
    JAX package draws two masks for a state, so an element there may
    take both values or neither.)"""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None
        self.generator = None

    def begin_state(self, batch_size=0, **kwargs):
        self._prev_output = None
        return self.base_cell.begin_state(batch_size, **kwargs)

    def _keep(self, rate, like):
        # a rematerialized region's recompute takes its first run's mask
        return _remat.keep("random", lambda: torch.rand(
            like.shape, generator=self.generator,
            device=like.device) < 1.0 - rate)

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        if autograd.is_training():
            if self._zo:
                prev = (self._prev_output if self._prev_output is not None
                        else torch.zeros_like(out))
                out = torch.where(self._keep(self._zo, out), out, prev)
            if self._zs:
                new_states = [torch.where(self._keep(self._zs, ns), ns, s)
                              for ns, s in zip(new_states, states)]
        self._prev_output = out
        return out, new_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forwards and ``r_cell`` backwards in time, outputs
    joined on the last axis; ``unroll`` only."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self.l_cell.begin_state(batch_size, **kwargs)
                + self.r_cell.begin_state(batch_size, **kwargs))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        if valid_length is not None:
            raise NotImplementedError("unroll: valid_length is not ported")
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self.begin_state(inputs.shape[layout.find("N")],
                                           device=inputs.device)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, inputs,
                                             begin_state[:nl], layout, True)
        r_out, r_states = self.r_cell.unroll(length, inputs.flip(axis),
                                             begin_state[nl:], layout, True)
        out = torch.cat([l_out, r_out.flip(axis)], dim=-1)
        return out, l_states + r_states

    def forward(self, inputs, states):
        raise NotImplementedError("BidirectionalCell supports unroll() only")


# Every cell is already a HybridBlock, so the reference's separate
# Hybrid* hierarchy collapses to aliases, as in the JAX package.
HybridRecurrentCell = RecurrentCell
HybridSequentialRNNCell = SequentialRNNCell
