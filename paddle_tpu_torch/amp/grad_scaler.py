"""GradScaler: the port of `paddle_tpu/amp/__init__.py:77-157` (loss
scaling). It scales only when the amp dtype is float16 at construction;
with bfloat16 (float32's exponent range) it passes the loss and the step
through unchanged, as the reference does. Enabled, it scales the loss,
unscales the gradients before the step, skips a step whose gradients are
not finite and moves the scale dynamically (`incr_every_n_steps` good
steps raise it by `incr_ratio`, `decr_every_n_nan_or_inf` bad ones lower
it by `decr_ratio`, never below 1)."""
from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        from . import amp_dtype
        self._enable = enable and amp_dtype() == "float16"
        self._scale = init_loss_scaling if self._enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found = False
        with torch.no_grad():
            for p in optimizer._parameter_list or []:
                if p is not None and p.grad is not None:
                    p.grad.mul_(inv)
                    found = found or not bool(torch.isfinite(p.grad).all())
        self._found_inf = found

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_scale_ratio(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]


__all__ = ["GradScaler"]
