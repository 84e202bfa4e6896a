"""fluid.layers 1.x completion (ref: python/paddle/fluid/layers/*; the
port of `paddle_tpu/fluid/layers_legacy.py`).

Everything here adapts a 1.x symbol onto the port's implementations
that already power the 2.0 namespaces: sequence ops come from the dense
LoD rework (nn/functional/sequence.py), detection from
nn/functional/detection.py, decay functions return the corresponding
LRScheduler, RNN cells/decoders come from nn. A handful of 1.x
graph-construction constructs that the reference itself superseded
(py_reader pipelines, DynamicRNN/StaticRNN/IfElse/Switch/While block
builders) raise with migration guidance — recorded in SURVEY.md §2 #42.
"""
from __future__ import annotations

import numpy as np

import torch

from .. import ops as _ops
from ..core.tensor import to_tensor

_py_range = range  # the 1.x `range` op below shadows the builtin


def _t(x, like=None):
    """x as a tensor (on `like`'s device when x is not one yet)."""
    if torch.is_tensor(x):
        return x
    return to_tensor(x, place=None if like is None else like.device)


def _on(x, arr):
    """A numpy result as a tensor on x's device."""
    return torch.as_tensor(np.asarray(arr), device=_t(x).device)


# ---------------------------------------------------------------- arithmetic

def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _ops.maximum(x, y)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _ops.minimum(x, y)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _ops.mod(x, y)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _ops.pow(x, y)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _ops.floor_divide(x, y)


def reduce_min(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.min(input, axis=dim, keepdim=keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.prod(input, axis=dim, keepdim=keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.all(input, axis=dim, keepdim=keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.any(input, axis=dim, keepdim=keep_dim)


def sums(input, out=None):  # noqa: A002
    r = input[0]
    for t in input[1:]:
        r = _ops.add(r, t)
    return r


def multiplex(inputs, index, name=None):
    """Row-wise select: out[i] = inputs[index[i]][i] (ref: multiplex_op)."""
    stacked = torch.stack([_t(t) for t in inputs])  # [n, batch, ...]
    idx = _t(index, stacked).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def cos_sim(X, Y):  # noqa: N803
    from ..nn.functional import cosine_similarity
    return cosine_similarity(X, Y, axis=-1)


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    from ..nn.functional import normalize
    return normalize(x, p=2, axis=axis, epsilon=epsilon)


def shape(input, name=None):  # noqa: A002
    return _on(input, np.asarray(_t(input).shape, np.int32))


def rank(input):  # noqa: A002
    return _on(input, np.asarray(_t(input).dim(), np.int32))


def size(input):  # noqa: A002
    return _on(input, np.asarray(_t(input).numel(), np.int64))


def is_empty(x, name=None):
    return _on(x, np.asarray(_t(x).numel() == 0))


def has_inf(x):
    return _ops.any(_ops.isinf(x))


def has_nan(x):
    return _ops.any(_ops.isnan(x))


def reverse(x, axis):
    return _ops.flip(x, axis)


def range(start, end, step, dtype, name=None):  # noqa: A001
    return _ops.arange(start, end, step, dtype=dtype)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,  # noqa: A002
                   name=None):
    return _ops.uniform(shape, dtype=dtype, min=min, max=max)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _ops.randn(shape, dtype=dtype) * std + mean


def _batch_size_like(ref, shape, input_dim_idx, output_dim_idx):
    shape = list(shape)
    shape[output_dim_idx] = _t(ref).shape[input_dim_idx]
    return shape


def fill_constant_batch_size_like(input, shape, dtype, value,  # noqa: A002
                                  input_dim_idx=0, output_dim_idx=0,
                                  force_cpu=False):
    return _ops.full(_batch_size_like(input, shape, input_dim_idx,
                                      output_dim_idx), value, dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):  # noqa: A002
    return uniform_random(_batch_size_like(input, shape, input_dim_idx,
                                           output_dim_idx), dtype, min, max,
                          seed)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,  # noqa: A002
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return gaussian_random(_batch_size_like(input, shape, input_dim_idx,
                                            output_dim_idx), mean, std, seed,
                           dtype)


def create_tensor(dtype, name=None, persistable=False):
    t = to_tensor(np.zeros((0,), dtype))
    t.persistable = persistable
    return t


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):  # noqa: A002
    """Sample one category id per row from softmax-ed scores (ref:
    sampling_id_op), from the port's generator of x's device."""
    from ..core import rng as rng_mod
    x = _t(x)
    probs = torch.softmax(x.detach().float(), -1)
    return torch.multinomial(probs, 1, generator=rng_mod.generator(
        x.device)).reshape(-1)


# ------------------------------------------------------------- activations

def hard_shrink(x, threshold=0.5):
    return _ops.hardshrink(x, threshold)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _ops.hardsigmoid(x, slope, offset)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _ops.hardswish(x)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from ..optimizer import lr
    return lr.ExponentialDecay(learning_rate, gamma=decay_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from ..optimizer import lr
    return lr.NaturalExpDecay(learning_rate, gamma=decay_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    from ..optimizer import lr
    return lr.InverseTimeDecay(learning_rate, gamma=decay_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from ..optimizer import lr
    return lr.PolynomialDecay(learning_rate, decay_steps, end_learning_rate,
                              power, cycle)


def piecewise_decay(boundaries, values):
    from ..optimizer import lr
    return lr.PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    from ..optimizer import lr
    return lr.CosineAnnealingDecay(learning_rate,
                                   T_max=step_each_epoch * epochs)


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    from ..optimizer import lr
    return lr.NoamDecay(d_model, warmup_steps, learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from ..optimizer import lr
    base = learning_rate if isinstance(learning_rate, float) \
        else getattr(learning_rate, "base_lr", end_lr)
    return lr.LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr) \
        if hasattr(lr, "LinearWarmup") else lr.PolynomialDecay(
            base, warmup_steps, end_lr)


# ---------------------------------------------------------------- pooling

def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,  # noqa: A002
        data_format="NCHW"):
    from ..nn import functional as F
    return F.local_response_norm(input, n, alpha=alpha, beta=beta, k=k,
                                 data_format=data_format)


def grid_sampler(x, grid, name=None):
    return _ops.grid_sample(x, grid)


def crop_tensor(x, shape=None, offsets=None, name=None):
    x = _t(x)
    offsets = offsets or [0] * x.dim()
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


def resize_linear(input, out_shape=None, scale=None, **kw):  # noqa: A002
    from ..nn.functional.legacy import image_resize
    return image_resize(input, out_shape, scale, resample="LINEAR")


def kldiv_loss(x, target, reduction="mean", name=None):
    from ..nn import functional as F
    return F.kl_div(x, target, reduction=reduction)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return torch.relu(-_t(label) * (_t(left) - _t(right)) + margin)


def rank_loss(label, left, right, name=None):
    """RankNet pairwise loss (ref: rank_loss_op): log(1 + e^o) - label o
    with o = left - right."""
    o = _t(left) - _t(right)
    return torch.log1p(torch.exp(o)) - _t(label) * o


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    from ..nn import functional as F
    return F.log_loss(input, label, epsilon)


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=
                                       True, use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Sampled softmax CE (ref: sample_logits_op): uniform negatives +
    the true class, softmax over the reduced set; the negatives come from
    the port's generator of the logits' device."""
    from ..core import rng as rng_mod
    lg, lb = _t(logits), _t(label).reshape(-1).long()
    bsz, n_cls = lg.shape
    negs = torch.randint(0, n_cls, (bsz, num_samples), device=lg.device,
                         generator=rng_mod.generator(lg.device))
    idx = torch.cat([lb[:, None], negs], -1)  # true first
    sel = torch.gather(lg, 1, idx)
    if remove_accidental_hits:
        hit = (idx == lb[:, None]) & \
            (torch.arange(idx.shape[1], device=lg.device)[None] > 0)
        sel = torch.where(hit, torch.full_like(sel, -1e20), sel)
    return -torch.log_softmax(sel, -1)[:, 0:1]


def edit_distance(input, label, normalized=True, ignored_tokens=None,  # noqa: A002
                  input_length=None, label_length=None):
    """Levenshtein distance per pair (ref: edit_distance_op). Dense
    [B, T] int sequences; a dynamic program on the host (the reference
    computes on the CPU too), the results on the input's device."""
    iv, lv = _t(input).cpu().numpy(), _t(label).cpu().numpy()

    def _dist(a, b):
        la, lb = len(a), len(b)
        dp = np.arange(lb + 1, dtype=np.int64)
        for i in _py_range(1, la + 1):
            prev = dp.copy()
            dp[0] = i
            for j in _py_range(1, lb + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (a[i - 1] != b[j - 1]))
        return dp[lb]

    def host(iv, lv, il, ll):
        out = np.zeros((iv.shape[0], 1), np.float32)
        seq_num = np.asarray([iv.shape[0]], np.int64)
        for b in _py_range(iv.shape[0]):
            a = iv[b][: int(il[b])] if il is not None else iv[b]
            c = lv[b][: int(ll[b])] if ll is not None else lv[b]
            if ignored_tokens:
                a = [t for t in a if t not in ignored_tokens]
                c = [t for t in c if t not in ignored_tokens]
            d = _dist(list(a), list(c))
            out[b, 0] = d / max(len(c), 1) if normalized else d
        return out, seq_num

    il = None if input_length is None else \
        _t(input_length).cpu().numpy()
    ll = None if label_length is None else \
        _t(label_length).cpu().numpy()
    out, seq_num = host(iv, lv, il, ll)
    return _on(input, out), _on(input, seq_num)


def mean_iou(input, label, num_classes):  # noqa: A002
    """Mean intersection-over-union over classes (ref: mean_iou_op)."""
    pv, lv = _t(input).cpu().numpy(), _t(label).cpu().numpy()
    ious, wrong, correct = [], [], []
    for c in np.arange(num_classes):
        pred_c = pv == c
        lbl_c = lv == c
        inter = np.logical_and(pred_c, lbl_c).sum()
        union = np.logical_or(pred_c, lbl_c).sum()
        if union > 0:
            ious.append(inter / union)
        correct.append(inter)
        wrong.append(np.logical_xor(pred_c, lbl_c).sum())
    miou = float(np.mean(ious)) if ious else 0.0
    return (_on(input, np.asarray(miou, np.float32)),
            _on(input, np.asarray(wrong, np.int64)),
            _on(input, np.asarray(correct, np.int64)))


# ------------------------------------------------------------- rnn family

def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    from ..nn.layer.rnn import RNN
    return RNN(cell, is_reverse=is_reverse, time_major=time_major)(
        inputs, initial_states)


def _superseded(name, replacement):
    def fn(*a, **kw):
        raise NotImplementedError(
            f"fluid.layers.{name} is a 1.x block-style program builder the "
            f"reference itself superseded; use {replacement} "
            f"(SURVEY.md §2 #42)")
    fn.__name__ = name
    return fn


py_reader = _superseded("py_reader", "paddle.io.DataLoader")
create_py_reader_by_data = _superseded("create_py_reader_by_data",
                                       "paddle.io.DataLoader")
double_buffer = _superseded("double_buffer",
                            "paddle.io.DataLoader (C++ prefetch built in)")
read_file = _superseded("read_file", "paddle.io.DataLoader")
load = _superseded("load", "paddle.static.load_inference_model")


def get_tensor_from_selected_rows(x, name=None):
    return x  # the rows are already a dense tensor


