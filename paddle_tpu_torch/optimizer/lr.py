"""Learning-rate schedulers: the port of `paddle_tpu/optimizer/lr.py`.

The reference's stateful API (`sched.step()`, `sched()`, `get_lr()`) and
its `lr_at(step)`, the schedule's value at an integer step as a pure
function of it (the optimizers' `functional_update` reads `lr_at(t)` at
its 1-based step t). The reference also evaluates `lr_at` on traced jax
integers inside a compiled step; the port's step runs on the host, so
every value here is a Python float computed from Python ints, by the
reference's own integer branches.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = None
        self.verbose = verbose
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def lr_at(self, step):
        """The schedule's value at integer `step`, leaving the state as it
        was."""
        saved = self.last_epoch
        try:
            self.last_epoch = int(step)
            return self.get_lr()
        finally:
            self.last_epoch = saved

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()

    def __call__(self):
        return self.last_lr

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries, self.values = list(boundaries), list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        e = self.last_epoch
        if self.cycle:
            div = max(1.0, math.ceil(e / self.decay_steps))
            frac = e / (self.decay_steps * div)
        else:
            frac = min(e, self.decay_steps) / self.decay_steps
        return (self.base_lr - self.end_lr) * (1 - frac) ** self.power \
            + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate \
            if isinstance(learning_rate, LRScheduler) else None
        self.peak = learning_rate if not self.lr_sched else None
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def get_lr(self):
        e = self.last_epoch
        warm = self.start_lr + (self.end_lr - self.start_lr) * (
            e / max(self.warmup_steps, 1))
        if e < self.warmup_steps:
            return warm
        if self.lr_sched is not None:
            return self.lr_sched.lr_at(e - self.warmup_steps)
        return self.peak


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    """As the reference: every `get_lr` at an epoch > 0 multiplies the
    running factor (so `lr_at` advances it too)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._acc = 1.0
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._acc *= self.lr_lambda(self.last_epoch)
        return self.base_lr * self._acc


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        cos = math.cos(math.pi * self.last_epoch / self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.up_steps = int(phase_pct * total_steps)
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        e = self.last_epoch
        up, down = self.up_steps, self.total_steps - self.up_steps

        def interp(lo, hi, frac):
            c = math.cos(math.pi * frac) * 0.5 + 0.5
            return lo + (hi - lo) * (1 - c)

        if e < up:
            return interp(self.initial_lr, self.max_lr, e / max(up, 1))
        frac = min((e - up) / max(down, 1), 1.0)
        return interp(self.max_lr, self.end_lr, frac)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode, self.exp_gamma = mode, exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        e = self.last_epoch
        cycle = e // (self.up + self.down)
        pos = e - cycle * (self.up + self.down)
        frac = pos / self.up if pos < self.up \
            else 1 - (pos - self.up) / self.down
        scale = {"triangular": 1.0, "triangular2": 0.5 ** cycle,
                 "exp_range": self.exp_gamma ** e}.get(self.mode, 1.0)
        return self.base_lr + (self.max_lr - self.base_lr) * frac * scale


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        m = float(metrics.item() if hasattr(metrics, "item") else metrics)
        margin = (abs(self.best) * self.threshold
                  if self.threshold_mode == "rel" else self.threshold) \
            if self.best is not None else 0.0
        better = (self.best is None
                  or (self.mode == "min" and m < self.best - margin)
                  or (self.mode == "max" and m > self.best + margin))
        if better:
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t_i, t_cur = self.T_0, max(self.last_epoch, 0)
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)) / 2


__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "LinearWarmup", "StepDecay", "MultiStepDecay", "LambdaDecay",
           "MultiplicativeDecay", "CosineAnnealingDecay", "OneCycleLR",
           "CyclicLR", "ReduceOnPlateau", "CosineAnnealingWarmRestarts"]
