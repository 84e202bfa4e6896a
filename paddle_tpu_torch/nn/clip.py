"""Gradient clipping: the port of `paddle_tpu/nn/clip.py`.

`ClipGradByValue`, `ClipGradByNorm` and `ClipGradByGlobalNorm` act on a
list of (param, grad) pairs (`__call__`) or, inside an optimizer's
stateful step, on the raw gradient list (`_clip_raw`); a tensor whose
`need_clip` attribute is False passes unclipped. `ClipGradByGlobalNorm.
clip_tree` scales a whole {name: grad} dict, the train steps' path; its
`sq_sum=` takes the sum of squares when the caller holds shards of the
gradients and must reduce it across ranks. `clip_grad_norm_` and
`clip_grad_value_` clip `.grad` in place.
"""
from __future__ import annotations

import torch


def _clippable(p):
    return getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        params = [p for p, _ in params_grads]
        grads = [g for _, g in params_grads]
        return list(zip(params, self._clip_raw(params, grads)))

    def _clip_raw(self, params, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def _clip_raw(self, params, grads):
        return [torch.clamp(g, self.min, self.max) if _clippable(p) else g
                for p, g in zip(params, grads)]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip_raw(self, params, grads):
        out = []
        for p, g in zip(params, grads):
            if not _clippable(p):
                out.append(g)
                continue
            norm = torch.sqrt(torch.sum(g * g))
            scale = torch.clamp_max(self.clip_norm / torch.clamp_min(
                norm, 1e-12), 1.0)
            out.append(g * scale)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def _scale(self, sq):
        return self.clip_norm / torch.clamp_min(torch.sqrt(sq),
                                                self.clip_norm)

    def _clip_raw(self, params, grads):
        sq = [torch.sum(g * g) for p, g in zip(params, grads)
              if _clippable(p)]
        if not sq:
            return grads
        scale = self._scale(sum(sq))
        return [g * scale if _clippable(p) else g
                for p, g in zip(params, grads)]

    def clip_tree(self, grads, sq_sum=None):
        """{name: grad} scaled by clip_norm / max(global norm, clip_norm).
        sq_sum: the sum of squares over every gradient (default: over
        these)."""
        if sq_sum is None:
            sq_sum = sum(torch.sum(g * g) for g in grads.values())
        scale = self._scale(sq_sum)
        return {n: g * scale for n, g in grads.items()}


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every `.grad` by min(max_norm / (total + 1e-6), 1); returns
    the total norm (the reference's eager helper)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([p.grad.abs().max() for p in params]))
    else:
        total = sum(torch.sum(p.grad.abs() ** norm_type)
                    for p in params) ** (1.0 / norm_type)
    scale = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    for p in params:
        p.grad = p.grad * scale
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm"]
