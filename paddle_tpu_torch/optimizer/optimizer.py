"""Optimizers of the training path: the port of `paddle_tpu.optimizer`'s
functional bridge for Adam and AdamW.

As in the reference, an optimizer is a per-leaf rule (`init_slots`,
`rule`) driven over a whole flat param dict by `functional_init` /
`functional_update`. The reference returns new arrays; the port updates
the params and slots IN PLACE under `torch.no_grad()` (no second copy of
the model or its moments), with torch's foreach ops across all leaves,
and returns the same dicts.

The AdamW step for each leaf p with gradient g at step t (1-based):
  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
  p = p - lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
        - lr * wd * p_old
where the decoupled decay uses the pre-update p and applies to every
leaf (biases and layer norms too) unless `wd_mask` names it False —
`optimizer.py:158-185` of the reference. Near-zero gradients make the
update about +-lr whatever their rounding, so a comparison of two
implementations holds parameters to a few lr, not to float eps.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


class Adam:
    """Adam over a flat {name: tensor} dict. `device` is where the params
    and slots live: None -> CUDA (raises without a card); pass "cpu" for
    the plain path."""

    _weight_decay = 0.0  # decoupled decay coefficient (AdamW sets it)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, device=None):
        self._lr = float(learning_rate)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self.device = resolve_device(device)

    def init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def rule(self, params, grads, slots, lr, t):
        """Update the leaves `params` in place from `grads` and their
        slots (a dict of per-leaf lists) at 1-based step t."""
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        mhat = torch._foreach_div(m, 1 - b1 ** t)
        denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
        torch._foreach_add_(denom, self._eps)
        torch._foreach_addcdiv_(params, mhat, denom, value=-lr)

    def functional_init(self, params):
        """params: {name: tensor} -> opt state {"slots": {name: {slot:
        tensor}}, "t": 0}."""
        for name, p in params.items():
            if p.device != self.device:
                raise ValueError(f"param {name!r} is on {p.device}; the "
                                 f"optimizer runs on {self.device}")
        return {"slots": {n: self.init_slots(p) for n, p in params.items()},
                "t": 0}

    @torch.no_grad()
    def functional_update(self, params, grads, opt_state, wd_mask=None):
        """One step over every leaf, in place. grads: {name: tensor}
        (cast to each param's dtype); wd_mask: {name: bool} selecting the
        leaves that decay (None: all). Returns (params, opt_state)."""
        t = opt_state["t"] + 1
        lr, wd = self._lr, self._weight_decay
        names = list(params)
        ps = [params[n] for n in names]
        gs = [grads[n].to(params[n].dtype) for n in names]
        decay = [params[n] for n in names
                 if wd > 0.0 and (wd_mask is None or wd_mask[n])]
        if decay:
            # - lr * wd * p_old, applied before the rule so it reads the
            # pre-update value
            torch._foreach_add_(decay, decay, alpha=-lr * wd)
        slots = opt_state["slots"]
        self.rule(ps, gs, {k: [slots[n][k] for n in names]
                           for k in slots[names[0]]}, lr, t)
        opt_state["t"] = t
        return params, opt_state


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01), as the
    reference's `AdamW`."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, device)
        self._weight_decay = float(weight_decay)


__all__ = ["Adam", "AdamW"]
