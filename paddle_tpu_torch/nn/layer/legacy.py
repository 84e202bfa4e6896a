"""The fluid-era layer classes the 2.0 `nn` namespace keeps (the port of
`paddle_tpu/nn/layer/legacy.py`): `Pool2D`, `AdaptiveMaxPool3D`,
`BilinearTensorProduct`, `RowConv`, `TreeConv`, `NCELoss`,
`HSigmoidLoss`, the `StaticRNN` / `DynamicRNN` recorders, and decoding —
`Decoder`, `BeamSearchDecoder`, `dynamic_decode` — and
`ctc_greedy_decoder`.

Parameters keep the reference's names and layouts (`weight`, `bias`),
drawn XavierUniform / zeros on the default device, so
`load_reference_state` carries the reference's weights across.
`NCELoss` draws its negative classes from the port's generator on its
device (torch's bits, not JAX's). Token and parent ids, the decoder's
and `ctc_greedy_decoder`'s outputs, are int64 (the reference's int32).

`BeamSearchDecoder` keeps a static beam: each step extends every beam
by every token (finished beams only by `end_token`, at no cost), keeps
the top `beam_size` summed log-probabilities of the [beam · vocab]
candidates, and reorders the cell states by the chosen parents;
`dynamic_decode` steps until every beam has finished (one host read a
step) or `max_step_num`, then traces the parents back (`gather_tree`).
"""
from __future__ import annotations

import torch

from ... import ops
from .. import functional as F
from .. import initializer as I
from ..functional import legacy as FL
from .layers import Layer


def _act(out, act):
    return getattr(ops, act)(out) if act else out


class Pool2D(Layer):
    """1.x pooling layer."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format="NCHW"):
        super().__init__()
        self._args = (pool_size, pool_type, pool_stride, pool_padding,
                      global_pooling, ceil_mode, data_format)

    def forward(self, x):
        (ps, pt, st, pd, gp, cm, df) = self._args
        return FL.pool2d(x, ps, pt, st, pd, gp, cm, data_format=df)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self._output_size)


class BilinearTensorProduct(Layer):
    """out_o = x1ᵀ W_o x2 + b_o."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            (output_dim, input1_dim, input2_dim),
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter((output_dim,), is_bias=True)
        self._act = act

    def forward(self, x1, x2):
        return _act(FL.bilinear(x1, x2, self.weight, self.bias), self._act)


class RowConv(Layer):
    """Lookahead convolution over time: out[t] = Σ_i x[t + i] ∘ w[i],
    i in [0, future_context_size], past the end zeros."""

    def __init__(self, num_channels, future_context_size, param_attr=None,
                 act=None):
        super().__init__()
        self.weight = self.create_parameter(
            (future_context_size + 1, num_channels),
            default_initializer=I.XavierUniform())
        self._act = act

    def forward(self, x):
        t = x.shape[1]
        pos = torch.arange(t, device=x.device)
        out = torch.zeros_like(x)
        for i in range(self.weight.shape[0]):
            rolled = torch.roll(x, -i, dims=1)
            valid = (pos + i < t)[None, :, None]
            out = out + torch.where(valid, rolled, torch.zeros_like(rolled)) \
                * self.weight[i][None, None, :]
        return _act(out, self._act)


class TreeConv(Layer):
    """Tree convolution over node features [B, N, F] and edges [B, E, 2]
    (parent, child): each hop distance d <= max_depth of the undirected
    tree has its own weight [F, output_size · num_filters]."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (max_depth + 1, feature_size, output_size * num_filters),
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter((output_size * num_filters,),
                                          is_bias=True)
        self._max_depth = max_depth
        self._act = act
        self._out = (output_size, num_filters)

    def forward(self, nodes_vector, edge_set):
        x = nodes_vector
        edges = edge_set.to(torch.int64)
        b, n, f = x.shape
        adj = torch.zeros((b, n, n), dtype=x.dtype, device=x.device)
        bidx = torch.arange(b, device=x.device)[:, None].expand(
            edges.shape[:2])
        adj[bidx, edges[..., 0], edges[..., 1]] = 1.0
        adj = adj + adj.transpose(1, 2)
        w = self.weight
        out = torch.einsum("bnf,fo->bno", x, w[0])
        reach = torch.eye(n, dtype=x.dtype, device=x.device)[None]
        for d in range(1, self._max_depth + 1):
            reach = torch.clamp(reach @ adj, 0, 1)
            out = out + torch.einsum("bnm,bmf,fo->bno", reach, x, w[d])
        out = out + self.bias
        o, nf = self._out
        return _act(out.reshape(b, n, o, nf), self._act)


class NCELoss(Layer):
    """Noise-contrastive estimation with `num_neg_samples` uniform
    negatives a row: [N, 1] losses."""

    def __init__(self, num_total_classes, dim, num_neg_samples=10,
                 name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_total_classes, dim), default_initializer=I.XavierUniform())
        self.bias = self.create_parameter((num_total_classes,),
                                          is_bias=True)
        self._n = num_total_classes
        self._k = num_neg_samples

    def forward(self, input, label):  # noqa: A002
        from ...core import rng
        lv = label.reshape(-1).to(torch.int64)
        w, b = self.weight, self.bias
        neg = torch.randint(0, self._n, (input.shape[0], self._k),
                            device=input.device,
                            generator=rng.generator(input.device))
        pos_logit = (input * w[lv]).sum(dim=1) + b[lv]
        neg_logit = torch.einsum("nd,nkd->nk", input, w[neg]) + b[neg]
        ln_k_pn = torch.log(torch.tensor(self._k / self._n,
                                         dtype=torch.float32))
        logsig = torch.nn.functional.logsigmoid
        pos_loss = -logsig(pos_logit - ln_k_pn)
        neg_loss = -logsig(-(neg_logit - ln_k_pn)).sum(dim=1)
        return (pos_loss + neg_loss)[:, None]


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size),
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter((num_classes - 1,), is_bias=True)
        self._num_classes = num_classes

    def forward(self, input, label, path_table=None, path_code=None):  # noqa: A002
        return FL.hsigmoid_loss(input, label, self._num_classes, self.weight,
                                self.bias, path_table, path_code)


class StaticRNN:
    """The 1.x static-graph RNN: it records step inputs,
    memories and outputs; define the step with `with rnn.step():`."""

    def __init__(self, name=None):
        self._inputs = []
        self._memories = []
        self._outputs = []
        self._step = None

    class _StepCtx:
        def __init__(self, rnn):
            self._rnn = rnn

        def __enter__(self):
            return self._rnn

        def __exit__(self, *a):
            return False

    def step(self):
        return StaticRNN._StepCtx(self)

    def step_input(self, x):
        self._inputs.append(x)
        return ("input", len(self._inputs) - 1)

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0):
        if init is None:
            b = batch_ref.shape[0] if batch_ref is not None else 1
            dev = batch_ref.device if torch.is_tensor(batch_ref) else None
            init = torch.full((b,) + tuple(shape), value,
                              dtype=torch.float32, device=dev)
        self._memories.append({"init": init, "cur": init, "next": None})
        return ("mem", len(self._memories) - 1)

    def update_memory(self, mem, new_val):
        self._memories[mem[1]]["next"] = new_val

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        raise NotImplementedError(
            "define the step with `with rnn.step():` then call rnn()")


class DynamicRNN(StaticRNN):
    """StaticRNN's contract over dense [B, T, ...] inputs."""


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _first(tree):
    return _first(tree[0]) if isinstance(tree, (list, tuple)) else tree


class Decoder:
    """The decode contract: initialize -> step -> finalize."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kw):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN cell (module docstring)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        k = self.beam_size
        states = _map(lambda s: s.repeat_interleave(k, dim=0),
                      initial_cell_states)
        leaf = _first(states)
        batch, dev = leaf.shape[0] // k, leaf.device
        tokens = torch.full((batch, k), self.start_token, dtype=torch.int64,
                            device=dev)
        log_probs = torch.tensor([[0.0] + [-1e9] * (k - 1)],
                                 dtype=torch.float32, device=dev).repeat(
                                     batch, 1)
        finished = torch.zeros((batch, k), dtype=torch.bool, device=dev)
        return tokens, (states, log_probs, finished)

    def step(self, time, inputs, states_tuple, **kw):
        cell_states, log_probs, finished = states_tuple
        b, k = inputs.shape
        flat = inputs.reshape(-1)
        emb = self.embedding_fn(flat) if self.embedding_fn else flat
        out, new_states = self.cell(emb, cell_states)
        logits = self.output_fn(out) if self.output_fn else out
        lv = torch.log_softmax(logits.float(), dim=-1)
        v = lv.shape[-1]
        lv = lv.reshape(b, k, v)
        # finished beams extend only with end_token, at no cost
        end_only = torch.full((v,), -1e9, device=lv.device)
        end_only[self.end_token] = 0.0
        lv = torch.where(finished[:, :, None], end_only[None, None, :], lv)
        total = log_probs[:, :, None] + lv  # [B, k, V]
        top_val, top_idx = torch.topk(total.reshape(b, k * v), k, dim=-1)
        parent = torch.div(top_idx, v, rounding_mode="floor")  # [B, k]
        token = top_idx % v
        rows = torch.arange(b, device=lv.device)[:, None]
        new_states = _map(
            lambda s: s.reshape(b, k, -1)[rows, parent].reshape(b * k, -1),
            new_states)
        new_finished = torch.take_along_dim(finished, parent, dim=1) | (
            token == self.end_token)
        return token, (new_states, top_val, new_finished), parent

    def finalize(self, outputs, final_states, parents):
        ids = torch.stack(outputs, dim=0)  # [T, B, beam]
        return FL.gather_tree(ids, torch.stack(parents, dim=0)), \
            final_states


def dynamic_decode(decoder, inits=None, max_step_num=32,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kw):
    """Step `decoder` until every beam finished or `max_step_num`
    (module docstring); returns (ids [T, B, beam], final states[,
    lengths])."""
    inputs, states = decoder.initialize(inits)
    outputs, parents = [], []
    for t in range(max_step_num):
        token, states, parent = decoder.step(t, inputs, states)
        outputs.append(token)
        parents.append(parent)
        inputs = token
        if bool(states[2].all()):
            break
    ids, final = decoder.finalize(outputs, states, parents)
    lens = (~states[2]).sum(dim=-1)
    if return_length:
        return ids, final, lens
    return ids, final


def ctc_greedy_decoder(input, blank, input_length=None,  # noqa: A002
                       padding_value=0, name=None):
    """Best-path CTC decoding: argmax, collapse repeats, drop blanks; the
    kept ids first in each row, padded to T with `padding_value`, and the
    per-row lengths [B, 1]."""
    ids = torch.argmax(input, dim=-1)  # [B, T]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev)
    b, t = ids.shape
    pos = torch.arange(t, device=ids.device)[None, :]
    if input_length is not None:
        keep = keep & (pos < input_length.reshape(-1, 1).to(ids.device))
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1)
    sorted_keep = torch.take_along_dim(keep, order, dim=1)
    sorted_ids = torch.take_along_dim(ids, order, dim=1)
    out = torch.where(sorted_keep, sorted_ids,
                      torch.full_like(sorted_ids, padding_value))
    return out, keep.sum(dim=1)[:, None]


__all__ = ["Pool2D", "AdaptiveMaxPool3D", "BilinearTensorProduct",
           "RowConv", "TreeConv", "NCELoss", "HSigmoidLoss", "StaticRNN",
           "DynamicRNN", "Decoder", "BeamSearchDecoder", "dynamic_decode",
           "ctc_greedy_decoder"]
