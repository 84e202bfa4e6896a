"""Recurrent layers: the port of `paddle_tpu/nn/layer/rnn.py` —
`SimpleRNNCell`, `LSTMCell`, `GRUCell`, `RNN` / `BiRNN` over any cell,
and the multi-layer, optionally bidirectional `SimpleRNN`, `LSTM`,
`GRU`.

The arithmetic, layouts and names are the reference's: weights
`weight_ih` [gates · hidden, in] and `weight_hh` [gates · hidden,
hidden], biases [gates · hidden], all uniform(±1/√hidden); LSTM gates
i, f, g, o (c' = f·c + i·g, h' = o·tanh(c')); GRU gates r, z, c with
c = tanh(x_c + r · (W_hc h + b_hc)) and h' = (1 - z)·c + z·h
(`:78-79`, `:196-197`); the multi-layer classes name their parameters
`weight_ih_l{k}[_reverse]`, ..., and return (out, (h, c)) for LSTM and
(out, h) otherwise, h / c [layers · directions, B, hidden]. The time loop
is a Python loop over the steps, the input projection of all steps one
product up front.
"""
from __future__ import annotations

import math

import torch

from ... import ops
from ...core import dtype as dtype_mod
from .. import initializer as I
from .layers import Layer


def _proj(x, w, b):
    """x @ w.T (+ b) over the last dim."""
    y = torch.matmul(x, w.t())
    return y + b if b is not None else y


def rnn_scan_simple(x, h0, wi, wh, bi, bh, activation="tanh"):
    """x [B, T, I] -> (out [B, T, H], h_T [B, H])."""
    act = torch.tanh if activation == "tanh" else torch.relu
    xp = _proj(x, wi, bi)
    h, outs = h0, []
    for t in range(x.shape[1]):
        h = act(xp[:, t] + _proj(h, wh, bh))
        outs.append(h)
    return torch.stack(outs, 1), h


def lstm_scan(x, h0, c0, wi, wh, bi, bh):
    """x [B, T, I]; gates i, f, g, o. Returns (out, h_T, c_T)."""
    xp = _proj(x, wi, bi)
    h, c, outs = h0, c0, []
    for t in range(x.shape[1]):
        gates = xp[:, t] + _proj(h, wh, bh)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, 1), h, c


def gru_scan(x, h0, wi, wh, bi, bh):
    """x [B, T, I]; gates r, z, c. Returns (out, h_T)."""
    xp = _proj(x, wi, bi)
    h, outs = h0, []
    for t in range(x.shape[1]):
        xr, xz, xc = torch.chunk(xp[:, t], 3, dim=-1)
        hr, hz, hc = torch.chunk(_proj(h, wh, bh), 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        cand = torch.tanh(xc + r * hc)
        h = (1 - z) * cand + z * h
        outs.append(h)
    return torch.stack(outs, 1), h


# --------------------------------------------------------------- cells ------

class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        shape = shape or (self.hidden_size,)
        if isinstance(shape, int):
            shape = (shape,)
        return torch.full([b] + list(shape), init_value,
                          dtype=dtype_mod.convert_dtype(dtype),
                          device=batch_ref.device)

    def _init_weights(self, input_size, hidden_size, n_gates, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr):
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            (n_gates * hidden_size, input_size), attr=weight_ih_attr,
            default_initializer=u)
        self.weight_hh = self.create_parameter(
            (n_gates * hidden_size, hidden_size), attr=weight_hh_attr,
            default_initializer=u)
        self.bias_ih = self.create_parameter(
            (n_gates * hidden_size,), attr=bias_ih_attr, is_bias=True,
            default_initializer=u)
        self.bias_hh = self.create_parameter(
            (n_gates * hidden_size,), attr=bias_hh_attr, is_bias=True,
            default_initializer=u)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._init_weights(input_size, hidden_size, 1, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        pre = _proj(inputs, self.weight_ih, self.bias_ih) + \
            _proj(h, self.weight_hh, self.bias_hh)
        h_new = act(pre)
        return h_new, h_new

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._init_weights(input_size, hidden_size, 4, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        gates = _proj(inputs, self.weight_ih, self.bias_ih) + \
            _proj(h, self.weight_hh, self.bias_hh)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._init_weights(input_size, hidden_size, 3, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        xr, xz, xc = torch.chunk(_proj(inputs, self.weight_ih, self.bias_ih),
                                 3, dim=-1)
        hr, hz, hc = torch.chunk(_proj(h, self.weight_hh, self.bias_hh), 3,
                                 dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        cand = torch.tanh(xc + r * hc)
        h_new = (1 - z) * cand + z * h
        return h_new, h_new

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """A cell run step by step over time (batch-major unless
    `time_major`), backwards with `is_reverse`."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(x.shape[0] - 1, -1, -1) if self.is_reverse \
            else range(x.shape[0])
        states, outs = initial_states, []
        for t in steps:
            out, states = self.cell(x[t], states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        out = torch.stack(outs, 0)
        return (out if self.time_major else out.transpose(0, 1)), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_states, bw_states = initial_states if initial_states \
            else (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, fw_states)
        out_bw, st_bw = self.rnn_bw(inputs, bw_states)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _FusedRNNBase(Layer):
    """Multi-layer, optionally bidirectional RNN over the scans above."""

    _mode = "LSTM"
    _gates = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        ndir = 2 if self.bidirect else 1
        self.num_directions = ndir
        ng = self._gates[self._mode]
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self._names = []
        for layer in range(num_layers):
            for d in range(ndir):
                isz = input_size if layer == 0 else hidden_size * ndir
                wi = self.create_parameter((ng * hidden_size, isz),
                                           attr=weight_ih_attr,
                                           default_initializer=u)
                wh = self.create_parameter((ng * hidden_size, hidden_size),
                                           attr=weight_hh_attr,
                                           default_initializer=u)
                bi = self.create_parameter((ng * hidden_size,),
                                           attr=bias_ih_attr, is_bias=True,
                                           default_initializer=u)
                bh = self.create_parameter((ng * hidden_size,),
                                           attr=bias_hh_attr, is_bias=True,
                                           default_initializer=u)
                sfx = f"l{layer}" + ("_reverse" if d else "")
                names = (f"weight_ih_{sfx}", f"weight_hh_{sfx}",
                         f"bias_ih_{sfx}", f"bias_hh_{sfx}")
                for n, p in zip(names, (wi, wh, bi, bh)):
                    self.add_parameter(n, p)
                self._names.append(names)

    def _weights(self, idx):
        return tuple(getattr(self, n) for n in self._names[idx])

    def _run_single(self, x, weights, h0, c0, reverse):
        if reverse:
            x = torch.flip(x, (1,))
        wi, wh, bi, bh = weights
        c = None
        if self._mode == "LSTM":
            out, h, c = lstm_scan(x, h0, c0, wi, wh,
                                  bi + bh if bi is not None else None, None)
        elif self._mode == "GRU":
            out, h = gru_scan(x, h0, wi, wh, bi, bh)
        else:
            out, h = rnn_scan_simple(x, h0, wi, wh,
                                     bi + bh if bi is not None else None,
                                     None, self.activation)
        if reverse:
            out = torch.flip(out, (1,))
        return out, h, c

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        b, ndir, nl = x.shape[0], self.num_directions, self.num_layers
        if initial_states is None:
            h0 = torch.zeros(nl * ndir, b, self.hidden_size,
                             dtype=torch.float32, device=x.device)
            c0 = torch.zeros_like(h0)
        elif self._mode == "LSTM":
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None
        h_outs, c_outs = [], []
        out = x
        for layer in range(nl):
            outs_dir = []
            for d in range(ndir):
                idx = layer * ndir + d
                cc = c0[idx] if c0 is not None and self._mode == "LSTM" \
                    else None
                o, h, c = self._run_single(out, self._weights(idx), h0[idx],
                                           cc, reverse=bool(d))
                outs_dir.append(o)
                h_outs.append(h)
                if c is not None:
                    c_outs.append(c)
            out = outs_dir[0] if ndir == 1 else torch.cat(outs_dir, dim=-1)
            if self.dropout > 0 and layer < nl - 1:
                out = ops.dropout(out, p=self.dropout, training=self.training)
        final_h = torch.stack(h_outs, 0)
        if self.time_major:
            out = out.transpose(0, 1)
        if self._mode == "LSTM":
            return out, (final_h, torch.stack(c_outs, 0))
        return out, final_h


class LSTM(_FusedRNNBase):
    _mode = "LSTM"


class GRU(_FusedRNNBase):
    _mode = "GRU"


class SimpleRNN(_FusedRNNBase):
    _mode = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        self._mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, **kw)


__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "LSTM", "GRU", "SimpleRNN", "rnn_scan_simple",
           "lstm_scan", "gru_scan"]
