"""Loss ops: the port of `paddle_tpu.ops.loss`'s `cross_entropy` and
`softmax_with_cross_entropy` (`paddle_tpu/ops/loss.py:16-90`), with the
reference's whole signature.

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


__all__ = ["cross_entropy", "softmax_with_cross_entropy"]
