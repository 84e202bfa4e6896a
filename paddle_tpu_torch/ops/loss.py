"""Loss ops of the training path: the port of `paddle_tpu.ops.loss`'s
`cross_entropy` for hard labels and mean reduction (the form GPT-2's
loss uses).

`cross_entropy(input [N, C], label [N], ignore_index=-100)`: log-softmax
over the last axis in the input's dtype, the negative log-likelihood of
each label, rows whose label equals `ignore_index` contributing zero,
divided by the number of valid rows (at least 1, so an all-ignored batch
gives 0, not NaN). Soft labels, class weights, label smoothing and the
other reductions are not ported yet.
"""
from __future__ import annotations

import torch


def cross_entropy(input, label, ignore_index=-100):  # noqa: A002
    logp = torch.log_softmax(input, dim=-1)
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = -logp.gather(-1, safe[..., None]).squeeze(-1)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)


__all__ = ["cross_entropy"]
