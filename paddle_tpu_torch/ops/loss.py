"""Loss ops: the port of `paddle_tpu/ops/loss.py` — `cross_entropy` and
`softmax_with_cross_entropy` (`:16-90`) with the reference's whole
signature, and the other losses below them in the reference's
arithmetic (`reduction` "mean" / "sum" / "none"; `kl_div` also
"batchmean"; `nll_loss` and weighted losses divide by the weights' sum).

`cross_entropy(input, label, weight=None, ignore_index=-100,
reduction="mean", soft_label=False, axis=-1, use_softmax=True,
label_smoothing=0.0)`:
  * log-probabilities over `axis` in the input's dtype: log-softmax, or
    with `use_softmax=False` the log of the input clamped at 1e-30;
  * hard labels (the default): the negative log-likelihood of each label
    (a label of shape [..., 1] on `axis` is squeezed); rows whose label is
    `ignore_index` contribute zero. With `label_smoothing` ε the target is
    (1 - ε)·one-hot + ε/k over the k classes; the port computes it as
    (1 - ε)·nll + (ε/k)·(−Σ logp) and never builds the one-hot (the same
    sum, in another order: within float32 rounding of the reference's);
  * soft labels: −Σ label·logp over `axis`, the labels smoothed to
    (1 - ε)·label + ε/k first;
  * `weight` [k]: each hard row scaled by its label's weight (zero when
    ignored), each soft row by Σ label·weight, and "mean" divides by
    max(Σ weights, 1e-12);
  * without weights "mean" divides hard labels by the number of valid
    rows (at least 1, so an all-ignored batch gives 0, not NaN) and soft
    labels by the number of rows; "sum" sums and "none" returns the
    per-row losses.
The default call (hard labels, mean, no weight, no smoothing; GPT-2's
and BERT's losses) runs none of the ops the other arguments add.

`softmax_with_cross_entropy(logits, label, soft_label=False,
ignore_index=-100, axis=-1, return_softmax=False)`: per-row losses with
`axis` kept (size 1), hard labels given with or without that axis;
optionally the softmax too.
"""
from __future__ import annotations

import torch


def _reduce(loss, reduction, weight_sum=None):
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if weight_sum is not None:
        return loss.sum() / weight_sum.clamp(min=1e-12)
    return loss.mean()


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    axis = axis % input.dim()
    logp = torch.log_softmax(input, dim=axis) if use_softmax else \
        torch.log(input.clamp(min=1e-30))
    k = input.shape[axis]
    if soft_label:
        labels = label
        if label_smoothing > 0:
            labels = labels * (1 - label_smoothing) + label_smoothing / k
        loss = -(labels * logp).sum(axis)
        if weight is not None:
            w = (labels * weight).sum(axis)
            return _reduce(loss * w, reduction, w.sum())
        return _reduce(loss, reduction)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * loss \
            + (label_smoothing / k) * -logp.sum(axis)
    if weight is not None:
        w = weight[safe] * valid.to(logp.dtype)
        loss = torch.where(valid, loss * w, 0.0)
        return _reduce(loss, reduction, w.sum())
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(axis, keepdim=True)
    else:
        lbl = label
        if not (lbl.dim() == logits.dim() and lbl.shape[axis] == 1):
            lbl = lbl.unsqueeze(axis)
        lbl = lbl.long()
        valid = lbl != ignore_index
        loss = -logp.gather(axis, torch.where(valid, lbl, 0))
        loss = torch.where(valid, loss, 0.0)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    x = torch.clamp(input, 1e-12, 1 - 1e-7)
    loss = -(label * torch.log(x) + (1 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (soft
                                              + torch.clamp_min(-logit, 0.0))
    else:
        loss = torch.clamp_min(logit, 0.0) - logit * label + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


sigmoid_cross_entropy_with_logits = binary_cross_entropy_with_logits


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def huber_loss(input, label, delta=1.0):  # noqa: A002
    d = torch.abs(input - label)
    return torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def kl_div(input, label, reduction="mean"):  # noqa: A002
    loss = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean"):
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    w = torch.ones_like(loss) if weight is None else weight[safe]
    w = w * valid.to(loss.dtype)
    loss = loss * w
    if reduction == "mean":
        return loss.sum() / w.sum().clamp(min=1e-12)
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    loss = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)


def hinge_loss(logits, labels):
    return torch.clamp_min(1.0 - logits * (2.0 * labels - 1.0), 0.0)


def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0.0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(anchor, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def d(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + epsilon, p),
                                   dim=-1), 1.0 / p)
    dp, dn = d(anchor, positive), d(anchor, negative)
    if swap:
        dn = torch.minimum(dn, d(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def _lse2(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    return torch.where(torch.isfinite(m),
                       m + torch.log(torch.exp(a - m_safe)
                                     + torch.exp(b - m_safe)), m)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """CTC by the forward recursion over log_probs [T, B, C] (log-softmaxed)
    and labels [B, S] padded with any value, the reference's in the same
    order of operations."""
    T, B, _ = log_probs.shape
    S = labels.shape[1]
    L = 2 * S + 1
    neg_inf = -1e30
    dev = log_probs.device
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    same2 = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    rows = torch.arange(B, device=dev)
    alpha = torch.full((B, L), neg_inf, dtype=log_probs.dtype, device=dev)
    alpha[:, 0] = log_probs[0, rows, ext[:, 0]]
    if S > 0:
        alpha[:, 1] = log_probs[0, rows, ext[:, 1]]
    alphas = [alpha]
    pad1 = torch.full((B, 1), neg_inf, dtype=log_probs.dtype, device=dev)
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([pad1, pad1, alpha[:, :-2]], dim=1)
        shift2 = torch.where(same2, neg_inf, shift2)
        alpha = _lse2(_lse2(alpha, shift1), shift2) \
            + log_probs[t].gather(1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # [T, B, L]
    t_idx = input_lengths.long().to(dev) - 1
    final = alphas[t_idx, rows]
    lab_len = label_lengths.long().to(dev)
    last = 2 * lab_len
    p_blank = final.gather(1, last[:, None])[:, 0]
    p_label = final.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    loss = -_lse2(p_blank, torch.where(lab_len > 0, p_label, neg_inf))
    if reduction == "mean":
        return torch.mean(loss / torch.clamp_min(lab_len, 1))
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    lbl = labels.reshape(-1)
    target = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    target = target / target.sum(1, keepdim=True)
    ce = -torch.mean(torch.sum(target * torch.log_softmax(sim, dim=1), 1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), 1))
                    + torch.mean(torch.sum(torch.square(positive), 1))) / 2
    return ce + reg


__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "sigmoid_cross_entropy_with_logits", "mse_loss",
           "square_error_cost", "l1_loss", "smooth_l1_loss", "huber_loss",
           "kl_div", "nll_loss", "margin_ranking_loss", "hinge_loss",
           "log_loss", "sigmoid_focal_loss", "cosine_embedding_loss",
           "triplet_margin_loss", "ctc_loss", "npair_loss"]
