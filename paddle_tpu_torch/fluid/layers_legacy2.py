"""fluid.layers 1.x completion, part 2 (ref: python/paddle/fluid/layers/
{control_flow,rnn,detection,metric_op,loss,nn}.py; the port of
`paddle_tpu/fluid/layers_legacy2.py`): decoders, host-side
debug ops, tensor arrays, metrics, and the remaining detection/loss ops.
Block-style 1.x program builders (While/IfElse/Switch/DynamicRNN/
StaticRNN) raise with migration guidance — SURVEY.md §2 #42."""
from __future__ import annotations

import numpy as np

import torch

from .. import ops as _ops
from .layers_legacy import _on, _t


def _host(x):
    return _t(x).detach().cpu().numpy()


# ------------------------------------------------------------ debug ops

def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Host-side tensor print (ref: control_flow.py Print)."""
    v = _t(input)
    msg = message or "Var"
    print(f"{msg} shape={tuple(v.shape)} "  # cli-print: Print op
          f"dtype={v.dtype}\n{_host(v).ravel()[:summarize]}")
    return input


def Assert(cond, data=None, summarize=20, name=None):  # noqa: N802
    """Runtime assert (ref: control_flow.py Assert): raises when cond is
    false anywhere."""
    if not bool(np.all(_host(cond))):
        extra = [_host(d).ravel()[:summarize] for d in (data or [])]
        raise ValueError(f"Assert failed; data={extra}")
    return None


# -------------------------------------------------------- tensor arrays

class Decoder:
    """Abstract decoder contract (initialize/step/finalize)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


class DecodeHelper:
    """Sampling contract for BasicDecoder (initialize/sample/next_inputs)."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: feed the ground-truth sequence (ref: rnn.py
    TrainingHelper). inputs: [B, T, ...] (batch-major)."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        iv = _t(inputs)
        self.inputs = iv if not time_major else iv.transpose(0, 1)
        self.sequence_length = None if sequence_length is None \
            else _t(sequence_length, iv)

    def initialize(self):
        t0 = self.inputs[:, 0]
        finished = torch.zeros(self.inputs.shape[0], dtype=torch.bool,
                               device=t0.device) \
            if self.sequence_length is None else (self.sequence_length <= 0)
        return t0, finished

    def sample(self, time, outputs, states):
        return _t(outputs).argmax(-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        t = int(_host(time)) + 1
        done = t >= self.inputs.shape[1]
        nxt = self.inputs[:, min(t, self.inputs.shape[1] - 1)]
        finished = torch.full((self.inputs.shape[0],), done,
                              device=nxt.device) \
            if self.sequence_length is None else \
            (self.sequence_length <= t)
        return finished, nxt, states


class GreedyEmbeddingHelper(DecodeHelper):
    """Feed back argmax embeddings (ref: rnn.py GreedyEmbeddingHelper)."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = _t(start_tokens)
        self.end_token = int(end_token)

    def initialize(self):
        finished = torch.zeros(self.start_tokens.shape[0], dtype=torch.bool,
                               device=self.start_tokens.device)
        return self.embedding_fn(self.start_tokens), finished

    def sample(self, time, outputs, states):
        return _t(outputs).argmax(-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        sid = _t(sample_ids)
        return sid == self.end_token, self.embedding_fn(sid), states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Feed back SAMPLED embeddings (ref: rnn.py SampleEmbeddingHelper)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature

    def sample(self, time, outputs, states):
        from ..core import rng as rng_mod
        logits = _t(outputs).detach().float()
        if self.temperature is not None:
            logits = logits / self.temperature
        return torch.multinomial(torch.softmax(logits, -1), 1,
                                 generator=rng_mod.generator(logits.device)
                                 ).reshape(-1)


class BasicDecoder(Decoder):
    """cell + helper -> one decode step (ref: rnn.py BasicDecoder).
    Works with paddle.nn.dynamic_decode."""

    class OutputWrapper:
        def __init__(self, cell_outputs, sample_ids):
            self.cell_outputs = cell_outputs
            self.sample_ids = sample_ids

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        (inputs, finished) = self.helper.initialize()
        return inputs, initial_cell_states, finished

    def step(self, time, inputs, states, **kwargs):
        outputs, next_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            outputs = self.output_fn(outputs)
        sample_ids = self.helper.sample(time, outputs, next_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, outputs, next_states, sample_ids)
        return (self.OutputWrapper(outputs, sample_ids), next_states,
                next_inputs, finished)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam step (ref: beam_search_op): [B*beam, V] scores -> top
    beam_size (ids, scores) per batch with parent indices."""
    sv = _t(scores).float()
    if not is_accumulated:
        sv = _t(pre_scores, sv).reshape(-1, 1) + torch.log(
            torch.clamp(sv, min=1e-20))
    # rows not divisible by beam_size = the first decode step (one row per
    # batch item): each row is its own group — never merge candidates
    # across batch boundaries
    nb = sv.shape[0] // beam_size if sv.shape[0] % beam_size == 0 \
        else sv.shape[0]
    v = sv.shape[-1]
    flat = sv.reshape(nb, -1)  # [B, beam*V]
    # a stable descending order (ties keep the lower index), as argsort
    top_i = torch.argsort(-flat, dim=-1, stable=True)[:, :beam_size]
    top_s = torch.gather(flat, 1, top_i)
    parent = top_i // v
    token = top_i % v
    sel_ids = token.reshape(-1, 1)
    sel_scores = top_s.reshape(-1, 1)
    if return_parent_idx:
        return sel_ids, sel_scores, parent.reshape(-1)
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """Backtrace beams to full sequences (ref: beam_search_decode_op), in
    the dense contract: per-step [B*beam, 1] tensors (or stacked
    [T, B*beam]) -> [B*beam, T] ids and scores."""
    iv = torch.stack([_t(t).reshape(-1) for t in ids]) \
        if isinstance(ids, (list, tuple)) else _t(ids)
    sv = torch.stack([_t(t).reshape(-1) for t in scores]) \
        if isinstance(scores, (list, tuple)) else _t(scores)
    return iv.T, sv.T


# ------------------------------------------------------------ 1.x blocks

def _block_builder(name):
    class _B:
        def __init__(self, *a, **kw):
            raise NotImplementedError(
                f"fluid.layers.{name} is a 1.x block-style program builder "
                f"superseded by the functional control flow; use "
                f"fluid.layers.cond/while_loop/case (SURVEY.md §2 #42)")
    _B.__name__ = name
    return _B


While = _block_builder("While")
IfElse = _block_builder("IfElse")
Switch = _block_builder("Switch")
DynamicRNN = _block_builder("DynamicRNN")
StaticRNN = _block_builder("StaticRNN")


# ---------------------------------------------------------- distributions

class MultivariateNormalDiag:
    """Diagonal-covariance multivariate normal (ref:
    fluid/layers/distributions.py MultivariateNormalDiag)."""

    def __init__(self, loc, scale):
        self.loc = _t(loc).float()
        # the reference passes a diagonal MATRIX; accept vector or matrix
        sv = _t(scale, self.loc).float()
        self.scale_diag = sv if sv.dim() == 1 else sv.diagonal()

    def sample(self, shape=()):
        from ..core import rng as rng_mod
        eps = torch.randn(tuple(shape) + tuple(self.loc.shape),
                          device=self.loc.device,
                          generator=rng_mod.generator(self.loc.device))
        return self.loc + eps * self.scale_diag

    def log_prob(self, value):
        v = _t(value, self.loc)
        var = self.scale_diag ** 2
        return (-0.5 * (torch.log(2 * np.pi * var)
                        + (v - self.loc) ** 2 / var)).sum(-1)

    def entropy(self):
        return (0.5 * torch.log(2 * np.pi * np.e *
                                self.scale_diag ** 2)).sum(-1)

    def kl_divergence(self, other):
        v1 = self.scale_diag ** 2
        v2 = other.scale_diag ** 2
        return (0.5 * (torch.log(v2 / v1) + (v1 + (self.loc - other.loc)
                                             ** 2) / v2 - 1.0)).sum(-1)


# --------------------------------------------------------------- pooling

def adaptive_pool2d(input, pool_size, pool_type="max",  # noqa: A002
                    require_index=False, name=None):
    from ..nn import functional as F
    fn = F.adaptive_max_pool2d if pool_type == "max" \
        else F.adaptive_avg_pool2d
    return fn(input, pool_size)


def adaptive_pool3d(input, pool_size, pool_type="max",  # noqa: A002
                    require_index=False, name=None):
    from ..nn import functional as F
    fn = F.adaptive_max_pool3d if pool_type == "max" \
        else F.adaptive_avg_pool3d
    return fn(input, pool_size)


# ------------------------------------------------------------- misc math

def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _ops.clip(x, t_min, t_max)


def inplace_abn(input, act=None, momentum=0.9, epsilon=1e-5, **kw):  # noqa: A002
    from ..static.nn import batch_norm as _bn
    return _bn(input, act=act, momentum=momentum, epsilon=epsilon, **kw)


def clip_by_norm(x, max_norm, name=None):
    """x scaled down to an L2 norm of at most max_norm (ref:
    clip_by_norm_op)."""
    x = _t(x)
    norm = torch.linalg.vector_norm(x.float())
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    return (x * scale).to(x.dtype)


def unique_with_counts(x, dtype="int32"):
    out, index, counts = _ops.unique(x, return_inverse=True,
                                     return_counts=True)
    return out, index, counts


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,  # noqa: A002
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    from ..nn import functional as F
    from ..static.nn import _create_param
    d = _t(input).shape[-1]
    w = _create_param((num_classes - 1, d), "float32", param_attr)
    b = _create_param((num_classes - 1,), "float32", bias_attr,
                      is_bias=True)
    return F.hsigmoid_loss(_t(input), _t(label), num_classes, w, b,
                           path_table=path_table, path_code=path_code)


# ----------------------------------------------------------------- losses

def auc(input, label, curve="ROC", num_thresholds=4095,  # noqa: A002
        topk=1, slide_steps=1):
    """Host-side AUC (ref: auc_op)."""
    from ..metric import Auc
    m = auc._metric = Auc(num_thresholds=num_thresholds)
    m.update(_host(input), _host(label))
    a = np.asarray(m.accumulate(), np.float32)
    return (_on(input, a), _on(input, a), [_on(input, a)])


def chunk_eval(input, label, chunk_scheme, num_chunk_types,  # noqa: A002
               excluded_chunk_types=None, seq_length=None):
    """Chunking precision/recall/F1 (ref: chunk_eval_op), IOB/IOE/IOBES
    schemes, host-side."""
    pv = _host(input).reshape(-1)
    lv = _host(label).reshape(-1)

    def extract(tags):
        # the O tag is num_chunk_types*n_tag (ref chunk_eval_op): it is
        # OUTSIDE every chunk — it terminates the open chunk, never
        # starts one
        chunks = []
        start = None
        ctype = None
        n_tag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[chunk_scheme]
        o_tag = num_chunk_types * n_tag
        for i, t in enumerate(tags):
            t = int(t)
            if t >= o_tag:  # Outside
                if start is not None:
                    chunks.append((start, i - 1, ctype))
                    start = None
                continue
            tag_type = t % n_tag
            cty = t // n_tag
            begin = (chunk_scheme == "IOB" and tag_type == 0) or \
                (chunk_scheme == "IOBES" and tag_type in (0, 3)) or \
                chunk_scheme == "plain"
            if begin or (start is not None and cty != ctype):
                if start is not None:
                    chunks.append((start, i - 1, ctype))
                start, ctype = i, cty
        if start is not None:
            chunks.append((start, len(tags) - 1, ctype))
        return set(chunks)

    pc, lc = extract(pv), extract(lv)
    tp = len(pc & lc)
    prec = tp / len(pc) if pc else 0.0
    rec = tp / len(lc) if lc else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return (_on(input, np.asarray(prec, np.float32)),
            _on(input, np.asarray(rec, np.float32)),
            _on(input, np.asarray(f1, np.float32)),
            _on(input, np.asarray(len(pc), np.int64)),
            _on(input, np.asarray(len(lc), np.int64)),
            _on(input, np.asarray(tp, np.int64)))


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,  # noqa: A002
                       name=None):
    """Greedy CTC decode: argmax, collapse repeats, strip blanks (ref:
    ctc_align_op). Dense [B, T, C] -> [B, T] padded ids."""
    pv = _host(input).argmax(-1)  # [B, T]
    outs = []
    for row in pv:
        seq = []
        prev = None
        for t in row:
            if t != prev and t != blank:
                seq.append(int(t))
            prev = t
        outs.append(seq)
    width = max((len(s) for s in outs), default=0)
    dense = np.full((len(outs), max(width, 1)), padding_value, np.int64)
    for i, s in enumerate(outs):
        dense[i, :len(s)] = s
    lens = np.asarray([len(s) for s in outs], np.int64)
    return _on(input, dense), _on(input, lens)


# --------------------------------------------------------- detection tail

def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (ref: matrix_nms_op): decay scores by pairwise IoU
    instead of hard suppression. Dense single-image [N,4]+[C,N]."""
    from ..nn.functional.detection import _iou_matrix
    bv = _t(bboxes).float()
    if bv.dim() == 3:
        bv = bv[0]
    sv = _t(scores, bv).float()
    if sv.dim() == 3:
        sv = sv[0]
    outs = []
    for c in range(sv.shape[0]):
        if c == background_label:
            continue
        s = sv[c]
        order = torch.argsort(-s, stable=True)[:nms_top_k]
        b = bv[order]
        s = s[order]
        # the reference pre-filters below score_threshold before the decay
        pre = s >= score_threshold
        iou = torch.triu(_iou_matrix(b, b), diagonal=1)
        max_iou = iou.max(0).values
        if use_gaussian:
            decay = torch.exp(-(max_iou ** 2) / gaussian_sigma)
        else:
            decay = 1 - max_iou
        s2 = s * decay
        keep = (s2 >= post_threshold) & pre
        for i in torch.nonzero(keep).reshape(-1).tolist():
            outs.append([c, float(s2[i]), *b[i].tolist()])
    outs.sort(key=lambda r: -r[1])
    outs = outs[:keep_top_k]
    arr = np.asarray(outs, np.float32) if outs else \
        np.zeros((0, 6), np.float32)
    if return_rois_num:
        return _on(bv, arr), _on(bv, np.asarray([len(outs)], np.int64))
    return _on(bv, arr)


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """Locality-aware NMS (ref: locality_aware_nms_op, EAST): weighted
    merge of consecutive overlapping boxes then standard NMS."""
    from ..nn.functional.detection import multiclass_nms
    return multiclass_nms(bboxes, scores,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)


