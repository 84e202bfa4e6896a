"""fluid.contrib (ref: python/paddle/fluid/contrib/; the port of
`paddle_tpu/fluid/contrib.py`) — the 1.x contrib grab-bag, mapped onto
the port. Cells, fusions and pooling ops are compositions of torch ops;
the CPU-cluster-only pieces (HDFS transfer, boxPS sparse pulls,
distributed program transpiles) raise with guidance — SURVEY.md §2 #42.

`mixed_precision.decorate(optimizer, init_loss_scaling=...)` wraps the
optimizer with an `amp.GradScaler` built when `decorate` is called. The
scaler scales the loss only when it is built inside a float16
`auto_cast` (`fluid.dygraph.amp_guard(dtype="float16")`): the
reference's `GradScaler` reads the amp dtype at construction
(`paddle_tpu/amp/__init__.py:84`), and the port keeps that rule
(ROADMAP §C 56). So a 1.x user calls `decorate` inside the guard."""
from __future__ import annotations

import numpy as np
import torch

from .. import ops as _ops
from ..nn.layer.rnn import GRUCell as BasicGRUUnit  # noqa: F401
from ..nn.layer.rnn import LSTMCell as BasicLSTMUnit  # noqa: F401
from .layers_legacy import _t


def basic_gru(input, init_hidden, hidden_size, num_layers=1,  # noqa: A002
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    from ..nn import GRU
    from ..nn.functional.legacy import legacy_param_store
    in_dim = _t(input).shape[-1]
    # parameters are identified by NAME (1.x program semantics) via the
    # LegacyParamStore — no shape-keyed sharing across distinct call sites
    net = legacy_param_store().layer(
        f"{name}/{in_dim}x{hidden_size}l{num_layers}b{int(bidirectional)}",
        lambda: GRU(in_dim, hidden_size, num_layers=num_layers,
                    direction="bidirect" if bidirectional else "forward"))
    out, h = net(_t(input), init_hidden)
    return out, h


def basic_lstm(input, init_hidden, init_cell, hidden_size,  # noqa: A002
               num_layers=1, sequence_length=None, dropout_prob=0.0,
               bidirectional=False, batch_first=True, param_attr=None,
               bias_attr=None, gate_activation=None, activation=None,
               forget_bias=1.0, dtype="float32", name="basic_lstm"):
    from ..nn import LSTM
    from ..nn.functional.legacy import legacy_param_store
    in_dim = _t(input).shape[-1]
    net = legacy_param_store().layer(
        f"{name}/{in_dim}x{hidden_size}l{num_layers}b{int(bidirectional)}",
        lambda: LSTM(in_dim, hidden_size, num_layers=num_layers,
                     direction="bidirect" if bidirectional else "forward"))
    states = None if init_hidden is None else (init_hidden, init_cell)
    out, (h, c) = net(_t(input), states)
    return out, h, c


def fused_bn_add_act(x, y, momentum=0.9, epsilon=1e-5, param_attr=None,
                     bias_attr=None, moving_mean_name=None,
                     moving_variance_name=None, act="relu", name=None):
    """bn(x) + y then act (ref: fused_bn_add_act), as a chain of ops."""
    from ..static.nn import batch_norm
    out = _ops.add(batch_norm(x, momentum=momentum, epsilon=epsilon,
                              param_attr=param_attr, bias_attr=bias_attr),
                   _t(y))
    return getattr(_ops, act)(out) if act else out


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """Apply functor chain like ['elementwise_add','relu'] (ref:
    fused_elemwise_activation_op), as a chain of ops."""
    out = _t(x)
    other = _t(y)
    for f in functor_list:
        if f.startswith("elementwise_"):
            from . import layers as L
            out = getattr(L, f)(out, other)
        elif f == "scale":
            out = _ops.scale(out, scale)
        else:
            out = getattr(_ops, f)(out)
    return out


def fused_embedding_seq_pool(input, size, is_sparse=False,  # noqa: A002
                             padding_idx=None, combiner="sum",
                             param_attr=None, dtype="float32"):
    """Embedding lookup + sequence pool in one op (ref:
    fused_embedding_seq_pool_op). Dense [B, T] ids -> [B, D]."""
    from ..static.nn import embedding
    emb = embedding(input, size, padding_idx=padding_idx,
                    param_attr=param_attr, dtype=dtype)
    return _ops.sum(emb, axis=1) if combiner == "sum" \
        else _ops.mean(emb, axis=1)


def _column_slices(input, start_index, length):
    parts = []
    for t in input:
        v = _t(t)
        end = v.shape[1] if length < 0 else start_index + length
        parts.append(v[:, start_index:end])
    return parts


def partial_concat(input, start_index=0, length=-1):  # noqa: A002
    """Concat column slices of each input (ref: partial_concat_op)."""
    return torch.cat(_column_slices(input, start_index, length), dim=1)


def partial_sum(input, start_index=0, length=-1):  # noqa: A002
    parts = _column_slices(input, start_index, length)
    return sum(parts[1:], parts[0])


def shuffle_batch(x, seed=None):
    """Shuffle rows across the batch (ref: shuffle_batch_op), by the
    port's generator of x's device."""
    from ..core import rng as rng_mod
    x = _t(x)
    perm = torch.randperm(x.shape[0], device=x.device,
                          generator=rng_mod.generator(x.device))
    return x[perm]


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):  # noqa: A002
    """Top-k average pooling over sequence scores (ref:
    sequence_topk_avg_pooling_op), dense [B, C, T] layout."""
    xv = _t(input)
    top = torch.sort(xv, dim=-1, descending=True).values
    outs = [top[..., :k].mean(-1) for k in topks]
    return torch.stack(outs, -1).reshape(xv.shape[0], -1)


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    """Semantic match matrix (ref: match_matrix_tensor_op): x W y^T per
    channel. Dense [B, Tx, D] x [B, Ty, D] -> [B, C, Tx, Ty]."""
    from .layers import create_parameter
    d = _t(x).shape[-1]
    w = create_parameter((d, channel_num, d), dtype, attr=param_attr)
    out = torch.einsum("btd,dce,bse->bcts", _t(x), w, _t(y))
    return (getattr(_ops, act)(out) if act else out), None


def var_conv_2d(input, row, col, input_channel, output_channel,  # noqa: A002
                filter_size, stride=1, param_attr=None, act=None,
                dtype="float32", name=None):
    """Variable-size 2d conv over sequence grids (ref: var_conv_2d_op) —
    dense rework: plain conv2d."""
    from ..static.nn import conv2d
    return conv2d(input, output_channel, filter_size, stride=stride,
                  param_attr=param_attr, act=act)


def rank_attention(input, rank_offset, rank_param_shape, rank_param_attr,  # noqa: A002
                   max_rank=3, max_size=0):
    """Rank-gated attention projection for CTR (ref: rank_attention_op):
    per-sample parameter block selected by rank pair."""
    from .layers import create_parameter
    w = create_parameter(tuple(rank_param_shape), "float32",
                         attr=rank_param_attr)
    xv = _t(input)
    block = w.reshape(max_rank * max_rank, xv.shape[1], -1)
    ranks = torch.clamp(_t(rank_offset, xv)[:, 0].long(), 0, max_rank - 1)
    return torch.einsum("bd,bdo->bo", xv, block[ranks])


def tdm_child(x, node_nums, child_nums, param_attr=None, dtype="int32"):
    """Tree-based deep model child lookup (ref: tdm_child_op): static tree
    info table [node_nums, child_nums] -> per-id children + leaf mask."""
    from .layers import create_parameter
    info = create_parameter((node_nums, child_nums), dtype, attr=param_attr)
    xv = _t(x)
    child = info.detach()[xv.reshape(-1).long()].reshape(
        tuple(xv.shape) + (child_nums,))
    return child, (child > 0).to(torch.int32)


def tdm_sampler(x, neg_samples_num_list, layer_node_num_list, leaf_node_num,
                tree_travel_attr=None, tree_layer_attr=None,
                output_positive=True, output_list=None, seed=0,
                tree_dtype="int32", dtype="int32"):
    """TDM negative sampler (ref: tdm_sampler_op): per tree layer, sample
    negatives uniformly from that layer's nodes."""
    from ..core import rng as rng_mod
    xt = _t(x)
    xv = xt.detach().cpu().numpy().reshape(-1)
    g = rng_mod.generator("cpu")
    outs, labels, masks = [], [], []
    start = 0
    for n_neg, n_nodes in zip(neg_samples_num_list, layer_node_num_list):
        negs = torch.randint(start, start + n_nodes, (xv.shape[0], n_neg),
                             generator=g).numpy()
        pos = xv[:, None] % max(n_nodes, 1) + start
        if output_positive:
            layer = np.concatenate([pos, negs], 1)
            lab = np.concatenate([np.ones_like(pos),
                                  np.zeros_like(negs)], 1)
        else:
            layer, lab = negs, np.zeros_like(negs)
        for dst, arr in ((outs, layer), (labels, lab),
                         (masks, np.ones_like(lab))):
            dst.append(torch.as_tensor(arr.astype(np.int32),
                                       device=xt.device))
        start += n_nodes
    return outs, labels, masks


def sparse_embedding(input, size, padding_idx=None, is_test=False,  # noqa: A002
                     entry=None, param_attr=None, dtype="float32"):
    """Distributed sparse embedding (ref: contrib/layers/sparse_embedding):
    the PS-lite host table is the sparse parameter here."""
    from ..distributed.ps import PSEmbedding
    from ..nn.functional.legacy import legacy_param_store
    nm = getattr(param_attr, "name", None) or \
        f"sparse_emb_{size[0]}x{size[1]}"
    layer = legacy_param_store().layer(
        nm, lambda: PSEmbedding(size[0], size[1]))
    return layer(_t(input))


def ctr_metric_bundle(input, label):  # noqa: A002
    """CTR metric bundle (ref: contrib/layers/metric_op.py): returns
    (auc, batch_auc, [stat tensors])."""
    from .layers_legacy2 import auc as _auc
    return _auc(input, label)


def bilateral_slice(x, guide, grid, has_offset=False, name=None):
    """HDRNet bilateral-grid slice (ref: bilateral_slice_op): the affine
    coefficients of the grid at (x, y, guide), linear in the guide."""
    xv, gv, grid_v = _t(x), _t(guide), _t(grid)
    b, c, h, w = xv.shape
    gd, gh, gw = grid_v.shape[2:]
    ys = torch.linspace(0, gh - 1, h, device=xv.device)
    xs = torch.linspace(0, gw - 1, w, device=xv.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    y0, x0 = torch.floor(yy).long(), torch.floor(xx).long()
    zz = torch.clamp(gv[:, 0] * (gd - 1), 0, gd - 1)  # [B, H, W]
    coeff = []
    for grid_b, z_b in zip(grid_v, zz):
        z0 = torch.floor(z_b).long()
        z1 = torch.clamp(z0 + 1, max=gd - 1)
        wz = z_b - z0
        g0 = grid_b[:, z0, y0, x0]
        g1 = grid_b[:, z1, y0, x0]
        coeff.append(g0 * (1 - wz) + g1 * wz)  # [C', H, W]
    coeff = torch.stack(coeff)
    n_out = coeff.shape[1] // (c + 1) if has_offset else \
        coeff.shape[1] // c
    cc = coeff.reshape(b, n_out, -1, h, w)
    out = torch.einsum("bochw,bchw->bohw", cc[:, :, :c], xv)
    if has_offset:
        out = out + cc[:, :, c]
    return out


def correlation(x, y, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1):
    """FlowNet correlation layer (ref: correlation_op): cost volume of
    shifted dot products."""
    xv, yv = _t(x), _t(y)
    _b, _c, h, w = xv.shape
    d = max_displacement
    yp = torch.nn.functional.pad(yv, (d, d, d, d))
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            shifted = yp[:, :, d + dy:d + dy + h, d + dx:d + dx + w]
            outs.append((xv * shifted).mean(1))
    return torch.stack(outs, 1)


def batch_fc(input, param_size, param_attr, bias_size, bias_attr,  # noqa: A002
             act=None):
    """Per-slot batched fc (ref: batch_fc_op): input [S, B, D] with its own
    [S, D, O] weight per slot."""
    from .layers import create_parameter
    w = create_parameter(tuple(param_size), "float32", attr=param_attr)
    bias = create_parameter(tuple(bias_size), "float32", attr=bias_attr,
                            is_bias=True)
    out = torch.einsum("sbd,sdo->sbo", _t(input), w) + bias[:, None]
    return getattr(_ops, act)(out) if act else out


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,  # noqa: A002
                        drop_out_percent, is_training, use_filter,
                        white_list_len, black_list_len, seed, lr,
                        param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None,
                        distribute_update_vars=None, dtype="float32"):
    """Pyramid hash embedding (ref: search_pyramid_hash_op): n-gram ids
    hashed into a shared space, summed per pyramid layer — simplified
    dense rework."""
    from .layers import create_parameter
    table = create_parameter((space_len, num_emb), dtype, attr=param_attr)
    xv = _t(input).long()
    acc = 0.0
    for n in range(1, pyramid_layer + 1):
        acc = acc + table[(xv * 131 + n) % space_len].sum(1)
    return acc


def extend_with_decoupled_weight_decay(base_optimizer):
    """AdamW-style decoupled decay wrapper (ref: contrib/optimizer.py):
    returns a class whose weight_decay applies after the update."""
    class DecoupledWeightDecay(base_optimizer):
        def __init__(self, *a, weight_decay=0.0, **kw):
            kw["weight_decay"] = weight_decay
            super().__init__(*a, **kw)

        def _decoupled(self):
            return True

    DecoupledWeightDecay.__name__ = \
        f"Decoupled{base_optimizer.__name__}"
    return DecoupledWeightDecay


class Momentum:
    """ref: contrib/optimizer.py Momentum (the fluid-era ctor); delegates
    to optimizer.Momentum."""

    def __new__(cls, *a, **kw):
        from ..optimizer import Momentum as M
        return M(*a, **kw)


# ---- CPU-cluster-only pieces: documented drops (SURVEY.md §2 #42) ----

def _cluster_only(name, why):
    def fn(*a, **kw):
        raise NotImplementedError(
            f"fluid.contrib.{name} targets the reference's CPU-cluster "
            f"runtime ({why}); not applicable to the port "
            f"(SURVEY.md §2 #42)")
    fn.__name__ = name
    return fn


from ..distributed.fleet.utils.fs import HDFSClient  # noqa: E402 — real
# hadoop-CLI client (fleet.utils.fs); raises ExecuteError with guidance
# when no hadoop install is present
multi_download = _cluster_only("multi_download", "HDFS file transfer")
multi_upload = _cluster_only("multi_upload", "HDFS file transfer")
_pull_box_extended_sparse = _cluster_only("_pull_box_extended_sparse",
                                          "BoxPS embedding service")
convert_dist_to_sparse_program = _cluster_only(
    "convert_dist_to_sparse_program", "DistributeTranspiler programs")
load_persistables_for_increment = _cluster_only(
    "load_persistables_for_increment", "lookup-table checkpoint shards")
load_persistables_for_inference = _cluster_only(
    "load_persistables_for_inference", "lookup-table checkpoint shards")
distributed_batch_reader = _cluster_only(
    "distributed_batch_reader", "trainer-sharded readers; use "
    "io.DistributedBatchSampler")


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    from ..nn.functional.detection import multiclass_nms
    return multiclass_nms(bboxes, scores, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    from .dygraph import TreeConv
    from ..nn.functional.legacy import legacy_param_store
    d = _t(nodes_vector).shape[-1]
    nm = (name or "tree_conv") + f"/{d}x{output_size}f{num_filters}"
    layer = legacy_param_store().layer(
        nm, lambda: TreeConv(d, output_size, num_filters, max_depth, act))
    return layer(_t(nodes_vector), _t(edge_set))


class mixed_precision:
    """Namespace shim for contrib.mixed_precision (ref:
    fluid/contrib/mixed_precision/) — decorate() maps onto amp."""

    @staticmethod
    def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
                 use_dynamic_loss_scaling=True, **kw):
        """1.x: returns an optimizer whose backward/minimize run under
        loss scaling (ref: contrib/mixed_precision/decorator.py): an
        `amp.GradScaler` built here, which scales only when this is
        called inside a float16 `auto_cast` (see the module docstring);
        otherwise it passes the loss and the step through unscaled."""
        from ..amp import GradScaler

        class _AmpOptimizer:
            def __init__(self, inner):
                self._inner = inner
                self._scaler = GradScaler(
                    init_loss_scaling=init_loss_scaling,
                    use_dynamic_loss_scaling=use_dynamic_loss_scaling)

            def backward(self, loss, **bkw):
                scaled = self._scaler.scale(loss)
                scaled.backward()
                return scaled

            def minimize(self, loss, **mkw):
                self.backward(loss)
                self._scaler.step(self._inner)
                self._scaler.update()
                return None, None

            def get_loss_scaling(self):
                return self._scaler.get_scale_ratio()

            def step(self):
                self._scaler.step(self._inner)
                self._scaler.update()

            def __getattr__(self, name):
                return getattr(self._inner, name)

        return _AmpOptimizer(optimizer)


class InitState:
    """Initial decoder state descriptor (ref: contrib/decoder/
    beam_search_decoder.py InitState): holds either a concrete init
    tensor or (shape, value) to materialize lazily."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is not None:
            from ..core import dtype as dtype_mod
            boot = _t(init_boot)
            # fill_constant_batch_size_like contract (ref beam_search_
            # decoder.py:83): shape[0] (usually -1) is replaced by the
            # boot batch dim, the rest is taken verbatim
            shape = list(shape) if shape else [-1]
            out_shape = [int(boot.shape[0])] + [int(s) for s in shape[1:]]
            self._init = torch.full(tuple(out_shape), value,
                                    dtype=dtype_mod.convert_dtype(dtype),
                                    device=boot.device)
        else:
            raise ValueError("init or init_boot must be provided")
        self.need_reorder = need_reorder

    @property
    def value(self):
        return self._init


class StateCell:
    """Decoder state container driving a step function (ref: contrib
    StateCell): registered states update each `compute_state` call via
    the user's cell; works eagerly (the decode loop is
    `paddle.nn.dynamic_decode`)."""

    def __init__(self, inputs=None, states=None, steps=None, name=None):
        self._states = dict(states or {})
        self._inputs = dict(inputs or {})
        self._cur_states = {s: (v.value if isinstance(v, InitState) else v)
                            for s, v in self._states.items()}
        self._updaters = []

    def get_state(self, name):
        if name not in self._cur_states:
            raise KeyError(f"unknown decoder state {name!r}")
        return self._cur_states[name]

    def get_input(self, name):
        if name not in self._inputs:
            raise KeyError(f"unknown decoder input {name!r}")
        return self._inputs[name]

    def set_state(self, name, value):
        self._cur_states[name] = value

    def state_updater(self, fn):
        self._updaters.append(fn)
        return fn

    def compute_state(self, inputs):
        self._inputs.update(inputs)
        for fn in self._updaters:
            fn(self)

    def out_state(self):
        return dict(self._cur_states)

    def update_states(self):
        pass  # eager semantics: set_state already committed


class TrainingDecoder:
    """The 1.x while-loop graph-builder decoder is superseded by the
    dynamic decoding stack: build a `paddle.nn.RNNCell`-style cell and
    train with teacher forcing directly, or decode with
    `paddle.nn.BeamSearchDecoder` + `paddle.nn.dynamic_decode`
    (block-style builder drop, same class as SURVEY §2 #42)."""

    def __init__(self, state_cell, name=None):
        raise NotImplementedError(
            "TrainingDecoder builds 1.x while_loop blocks; run the cell "
            "directly over the time axis (teacher forcing is a Python "
            "loop of cell calls) or use paddle.nn.dynamic_decode. "
            "StateCell/InitState remain usable as state containers.")


class BeamSearchDecoder:
    """See TrainingDecoder — inference-side of the same block builder."""

    def __init__(self, state_cell, *a, **kw):
        raise NotImplementedError(
            "contrib.BeamSearchDecoder builds 1.x while_loop blocks; use "
            "paddle.nn.BeamSearchDecoder with paddle.nn.dynamic_decode "
            "(tested in tests/test_beam_search.py), or model.generate() "
            "for KV-cache decoding.")


class QuantizeTranspiler:
    """Static-graph quantization transpiler (ref: contrib/slim
    QuantizeTranspiler): superseded by the imperative quantization in
    paddle.slim — ImperativeQuantAware (QAT) and
    PostTrainingQuantization (PTQ), both able to export a servable int8
    artifact via save_quantized_model."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "QuantizeTranspiler rewrites 1.x Programs; quantize the Layer "
            "instead: paddle.slim.ImperativeQuantAware().quantize(model) "
            "for QAT or paddle.slim.PostTrainingQuantization for PTQ, "
            "then save_quantized_model() for the int8 artifact.")


# ---- reference module-attribute surface of fluid.contrib (ref:
# fluid/contrib/__init__.py import list) ----
import sys as _sys

layers = _sys.modules[__name__]  # contrib layer fns live flat, right here


class AutoMixedPrecisionLists:
    """Op allow/deny lists consulted by AMP decoration (ref:
    contrib/mixed_precision/fp16_lists.py). The port's AMP policy casts by
    op category; custom lists extend/shrink the categories."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(custom_white_list or [])
        self.black_list = set(custom_black_list or [])
        self.black_varnames = set(custom_black_varnames or [])


decorate = mixed_precision.decorate  # 1.x top-level spelling


class decoder:  # ref: contrib/decoder/__init__
    pass


class beam_search_decoder:  # ref: contrib/decoder/beam_search_decoder.py
    pass


class quantize:  # ref: contrib/quantize/__init__
    pass


class extend_optimizer:  # ref: contrib/extend_optimizer/__init__
    @staticmethod
    def extend_with_decoupled_weight_decay(base_optimizer):
        """Build <Base>WithDecoupledWeightDecay: the BASE update rule
        plus weight decay applied directly to params, not to grads (ref:
        contrib/extend_optimizer/extend_optimizer_with_weight_decay.py).
        Adam maps onto the native AdamW; any other optimizer gets a
        subclass that decays params before its own step."""
        from ..optimizer import Adam, AdamW
        if base_optimizer is Adam:
            class AdamWithDecoupledWeightDecay(AdamW):
                def __init__(self, *args, coeff=0.01, **kwargs):
                    # 1.x spells the decay strength `coeff`
                    kwargs.setdefault("weight_decay", coeff)
                    super().__init__(*args, **kwargs)

            return AdamWithDecoupledWeightDecay

        class OptimizerWithDecoupledWeightDecay(base_optimizer):
            def __init__(self, *args, coeff=0.01, **kwargs):
                super().__init__(*args, **kwargs)
                self._wd_coeff = float(coeff)

            def step(self):
                lr = float(self.get_lr())
                with torch.no_grad():
                    for p in self._parameter_list or []:
                        if p is not None and getattr(p, "trainable", True) \
                                and p.grad is not None:
                            p.mul_(1.0 - lr * self._wd_coeff)
                super().step()

        OptimizerWithDecoupledWeightDecay.__name__ = \
            base_optimizer.__name__ + "WithDecoupledWeightDecay"
        return OptimizerWithDecoupledWeightDecay


def memory_usage(program, batch_size=1):
    """Rough activation+param memory of a Program in MB (ref:
    contrib/memory_usage_calc.py): sum of var numel × dtype width, batch
    dim filled with `batch_size`."""
    import numpy as np
    total = 0
    for var in program.global_block().vars.values():
        shape = [batch_size if (s is None or s < 0) else s
                 for s in (var.shape or ())]
        width = 2 if "16" in str(var.dtype) else 8 \
            if "64" in str(var.dtype) else 4
        total += int(np.prod(shape)) * width if shape else width
    return total / (1 << 20)


class memory_usage_calc:
    memory_usage = staticmethod(memory_usage)


class model_stat:  # ref: contrib/model_stat.py (param/flops table)
    @staticmethod
    def summary(main_prog):
        n_params = sum(
            1 for v in main_prog.global_block().vars.values()
            if getattr(v, "persistable", False))
        print(f"Program: {n_params} persistable vars")  # cli-print: report


def op_freq_statistic(program):
    """Op-type frequency of a Program (ref: contrib/op_frequence.py)."""
    from collections import Counter
    uni = Counter(op.type for op in program.global_block().ops)
    adj = Counter()
    ops_ = program.global_block().ops
    for a, b in zip(ops_, ops_[1:]):
        adj[f"{a.type}->{b.type}"] += 1
    return uni, adj


class op_frequence:
    op_freq_statistic = staticmethod(op_freq_statistic)


class _QatModule:
    """slim.quantization.imperative.qat — the 1.x import home of
    ImperativeQuantAware (ref: contrib/slim/quantization/imperative/
    qat.py); the implementation is the port's `slim`."""


class slim:  # ref: contrib/slim/__init__ — 1.x home of quantization
    class quantization:
        class imperative:
            qat = _QatModule

        @staticmethod
        def _bind():
            pass


def _bind_slim():
    from .. import slim as _slim_mod
    slim.quantization.ImperativeQuantAware = _slim_mod.ImperativeQuantAware
    slim.quantization.PostTrainingQuantization = \
        _slim_mod.PostTrainingQuantization
    slim.quantization.QuantizeTranspiler = QuantizeTranspiler
    _QatModule.ImperativeQuantAware = _slim_mod.ImperativeQuantAware
    decoder.InitState = InitState
    decoder.StateCell = StateCell
    decoder.TrainingDecoder = TrainingDecoder
    decoder.BeamSearchDecoder = BeamSearchDecoder
    decoder.beam_search_decoder = beam_search_decoder
    beam_search_decoder.InitState = InitState
    beam_search_decoder.StateCell = StateCell
    beam_search_decoder.TrainingDecoder = TrainingDecoder
    beam_search_decoder.BeamSearchDecoder = BeamSearchDecoder
    quantize.QuantizeTranspiler = QuantizeTranspiler
    from .. import optimizer as _opt
    from .. import reader as _reader
    globals()["optimizer"] = _opt
    globals()["reader"] = _reader


_bind_slim()


class utils:
    """contrib.utils (ref: contrib/utils/hdfs_utils.py). HDFSClient here
    operates on local paths with the same method surface, so staging code
    runs against mounted filesystems (a cluster FS appears as a mount)."""

    class HDFSClient:
        def __init__(self, hadoop_home=None, configs=None):
            pass

        def is_exist(self, path):
            import os
            return os.path.exists(path)

        def is_dir(self, path):
            import os
            return os.path.isdir(path)

        def ls(self, path):
            import os
            return sorted(os.path.join(path, f)
                          for f in os.listdir(path))

        def mkdirs(self, path):
            import os
            os.makedirs(path, exist_ok=True)

        def delete(self, path):
            import os
            import shutil
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.exists(path):
                os.remove(path)

        def upload(self, hdfs_path, local_path, overwrite=True,
                   retry_times=5):
            import shutil
            shutil.copy(local_path, hdfs_path)

        def download(self, hdfs_path, local_path, overwrite=True):
            import shutil
            shutil.copy(hdfs_path, local_path)

    @staticmethod
    def multi_download(client, hdfs_path, local_path, trainer_id,
                      trainers, file_cnt=None):
        import os
        files = client.ls(hdfs_path)
        mine = [f for i, f in enumerate(sorted(files))
                if i % trainers == trainer_id]
        os.makedirs(local_path, exist_ok=True)
        for f in mine:
            client.download(f, os.path.join(local_path,
                                            os.path.basename(f)))
        return mine

    @staticmethod
    def multi_upload(client, hdfs_path, local_path, multi_processes=5,
                     overwrite=False):
        import os
        client.mkdirs(hdfs_path)
        for f in sorted(os.listdir(local_path)):
            client.upload(os.path.join(hdfs_path, f),
                          os.path.join(local_path, f))
