"""Optimizers: the port of `paddle_tpu/optimizer/optimizer.py`.

As in the reference, an optimizer is a per-leaf rule (`init_slots`,
`rule`) driven two ways:

  * the functional bridge, `functional_init` / `functional_update(params,
    grads, opt_state, lr=None, wd_mask=None)` over a whole flat {name:
    tensor} dict (or one tensor) — the train steps' path. The reference
    returns new arrays; the port updates the params and slots IN PLACE
    under `torch.no_grad()` (no second copy of the model or its moments)
    and returns the same dicts. `lr` defaults to the float learning rate
    or the scheduler's `lr_at(t)` at the 1-based step t
    (`optimizer.py:152-186`); a weight decay couples into the gradient
    (g + coeff * p) before the rule, or for AdamW decouples (- lr * coeff
    * p_old) — on every leaf unless `wd_mask` names it False.
  * the stateful API in PyTorch's idiom: `parameters=` a list of tensors,
    of (name, tensor) pairs (`module.named_parameters()`), or of
    param-group dicts with "params" and an optional "learning_rate" /
    "weight_decay"; `step()` reading each tensor's `.grad`, `clear_grad`,
    `minimize(loss)`, `get_lr` / `set_lr`, and `state_dict` /
    `set_state_dict` with the reference's keys ("@step",
    "{name}.{slot}", "LR_Scheduler"). A tensor's name is the one it was
    given, else its `param_name` (a layer's parameters), else "param_{i}"
    — so a fresh model's optimizer loads a saved state by order and shape,
    with the reference's warning; `regularizer`, `optimize_attr`
    ({"learning_rate": scale}), `need_clip`, `trainable` and
    `no_weight_decay` attributes act as the reference's Parameter
    fields. The coupled regularizer of a step is `L2Decay`, `L1Decay`
    (sign(p) * coeff) or a float (`_apply_regularization`, `:78-90`).

The rules (`:302-506`): SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb and Lars, each in the reference's arithmetic.
Adam's step runs torch's foreach ops across all leaves; the others loop
over the leaves. Lamb's and Lars' trust ratios take norms of whole
leaves: a caller holding a shard of a leaf (ZeRO) passes `norms=` — a
{name: fn(tensor) -> the whole leaf's norm} — to `functional_update`.

Every optimizer has a `device` (None: the first card, raising without
one; "cpu" for the plain path); the params it updates must live there.
"""
from __future__ import annotations

import warnings

import torch

from ..device import resolve_device
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler


def _vnorm(x):
    return torch.linalg.vector_norm(x)


class Optimizer:
    decoupled = False  # AdamW: the decay is applied beside the rule

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, device=None):
        self._lr = learning_rate
        self.device = resolve_device(device)
        self._parameter_list = list(parameters) \
            if parameters is not None else None
        self._names = {}  # id(param) -> its name, from (name, tensor) pairs
        if self._parameter_list and \
                isinstance(self._parameter_list[0], tuple):
            self._names = {id(t): n for n, t in self._parameter_list}
            self._parameter_list = [t for _, t in self._parameter_list]
        self._param_groups = None
        self._group_of = {}  # id(param) -> its group dict
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            self._param_groups = self._parameter_list
            flat = []
            for g in self._param_groups:
                for p in g["params"]:
                    flat.append(p)
                    self._group_of[id(p)] = g
            self._parameter_list = flat
        for p in self._parameter_list or []:
            if p is not None and p.device != self.device:
                raise ValueError(f"a parameter is on {p.device}; the "
                                 f"optimizer runs on {self.device}")
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._slots = {}  # id(param) -> {slot: tensor}
        self._step_count = 0
        self._name = name

    # ---- the rule (subclasses) -------------------------------------------
    def init_slots(self, p):
        """{slot: tensor} for one leaf `p`."""
        return {}

    def rule(self, params, grads, slots, lr, t, norms=None):
        """Update the leaves `params` in place from `grads` and their slots
        ({slot: [tensor per leaf]}) at 1-based step t. norms: per leaf a
        fn(tensor) -> norm of the whole leaf (Lamb, Lars), or None."""
        for i, (p, g) in enumerate(zip(params, grads)):
            self.leaf_rule(p, g, {k: v[i] for k, v in slots.items()}, lr, t,
                           norms[i] if norms else _vnorm)

    def leaf_rule(self, p, g, s, lr, t, norm):
        raise NotImplementedError

    # ---- lr ----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("optimizer lr is a scheduler; call "
                               "sched.step()")
        self._lr = value

    # ---- weight decay ------------------------------------------------------
    def _decay_coeff(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if hasattr(wd, "coeff"):
            return float(wd.coeff) if isinstance(wd, L2Decay) else 0.0
        return float(wd)

    def _apply_regularization(self, p, g):
        reg = getattr(p, "regularizer", None) or self._weight_decay
        if reg is None or self.decoupled:
            return g
        if isinstance(reg, L1Decay):
            return g + reg.coeff * torch.sign(p)
        if hasattr(reg, "coeff"):
            return g + reg.coeff * p
        return g + float(reg) * p

    # ---- the stateful API --------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer constructed without parameters")
        self._step_count += 1
        lr = self.get_lr()
        live, grads = [], []
        for p in params:
            if p is None or p.grad is None or \
                    not getattr(p, "trainable", True):
                continue
            g = self._apply_regularization(p, p.grad.to(p.dtype))
            live.append(p)
            grads.append(g)
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_raw(live, grads)
        for p, g in zip(live, grads):
            slots = self._slots.get(id(p))
            if slots is None:
                slots = self._slots[id(p)] = self.init_slots(p)
            group = self._group_of.get(id(p))
            p_lr = lr * getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)
            if group is not None and "learning_rate" in group:
                p_lr = lr * group["learning_rate"]
            wd = self._decay_coeff()
            if group is not None and "weight_decay" in group:
                gw = group["weight_decay"]
                wd = float(gw.coeff) if hasattr(gw, "coeff") else float(gw)
            old = p.clone() if self.decoupled and wd > 0.0 else None
            self.rule([p], [g], {k: [v] for k, v in slots.items()}, p_lr,
                      self._step_count)
            if old is not None and \
                    getattr(p, "no_weight_decay", False) is False:
                p.sub_(p_lr * wd * old)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None, parameter_list=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            if p is not None:
                p.grad = None

    clear_gradients = clear_grad

    # ---- the functional bridge ---------------------------------------------
    def functional_init(self, params):
        """params: {name: tensor} (or one tensor) -> opt state {"slots":
        {name: {slot: tensor}} (or {slot: tensor}), "t": 0}."""
        single = torch.is_tensor(params)
        tree = {"": params} if single else params
        for name, p in tree.items():
            if p.device != self.device:
                raise ValueError(f"param {name!r} is on {p.device}; the "
                                 f"optimizer runs on {self.device}")
        slots = {n: self.init_slots(p.detach()) for n, p in tree.items()}
        return {"slots": slots[""] if single else slots, "t": 0}

    @torch.no_grad()
    def functional_update(self, params, grads, opt_state, lr=None,
                          wd_mask=None, norms=None):
        """One step over every leaf, in place. grads: {name: tensor}
        (cast to each param's dtype); wd_mask: {name: bool} selecting the
        leaves that decay (None: all); norms: {name: fn} for leaves held
        in part (see the module docstring). Returns (params, opt_state)."""
        if torch.is_tensor(params):
            p, s = self.functional_update(
                {"": params}, {"": grads},
                {"slots": {"": opt_state["slots"]}, "t": opt_state["t"]},
                lr, None if wd_mask is None else {"": wd_mask},
                None if norms is None else {"": norms})
            opt_state.update(t=s["t"])
            return params, opt_state
        t = opt_state["t"] + 1
        if lr is None:
            lr = self._lr.lr_at(t) if isinstance(self._lr, LRScheduler) \
                else self._lr
        coeff = self._decay_coeff()
        names = list(params)
        ps = [params[n] for n in names]
        gs = [grads[n].to(params[n].dtype) for n in names]
        decays = [coeff > 0.0 and (wd_mask is None or bool(wd_mask[n]))
                  for n in names]
        if self.decoupled:
            decay = [p for p, d in zip(ps, decays) if d]
            if decay:
                # - lr * coeff * p_old, applied before the rule so it reads
                # the pre-update value
                torch._foreach_add_(decay, decay, alpha=-lr * coeff)
        else:
            gs = [g + coeff * p if d else g
                  for p, g, d in zip(ps, gs, decays)]
        slots = opt_state["slots"]
        keys = slots[names[0]] if names else {}
        self.rule(ps, gs, {k: [slots[n][k] for n in names] for k in keys},
                  lr, t, None if norms is None else
                  [norms.get(n, _vnorm) for n in names])
        opt_state["t"] = t
        return params, opt_state

    # ---- state dict --------------------------------------------------------
    def state_dict(self):
        out = {"@step": self._step_count}
        for pid, name in self._param_names().items():
            for k, v in self._slots.get(pid, {}).items():
                out[f"{name}.{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        """Load a `state_dict`: by name, else (the names regenerated) by
        order and shape, as the reference. Everything is checked before
        anything changes."""
        names = {name: pid for pid, name in self._param_names().items()}
        saved_pnames, saved_slots = [], {}
        for key, v in state.items():
            if key in ("@step", "LR_Scheduler"):
                continue
            pname, slot = key.rsplit(".", 1)
            if pname not in saved_pnames:
                saved_pnames.append(pname)
            # a copy: the slots are updated in place, and the state may
            # be another live optimizer's
            saved_slots.setdefault(pname, {})[slot] = torch.as_tensor(
                v, device=self.device).clone()
        cur = [p for p in (self._parameter_list or []) if p is not None]
        unmatched = [pn for pn in saved_pnames if pn not in names]
        if not unmatched:
            mapping = {pn: names[pn] for pn in saved_pnames}
        else:
            bearing = [p for p in cur if getattr(p, "trainable", True)]
            if len(saved_pnames) > len(bearing):
                raise ValueError(
                    f"optimizer state has {len(saved_pnames)} parameter "
                    f"groups but the model has only {len(bearing)} "
                    "trainable parameters — positional resume would "
                    "misalign moments; architectures differ")
            mapping, ci = {}, 0
            for pn in saved_pnames:
                want = next((tuple(a.shape) for a in
                             saved_slots[pn].values() if a.dim()), None)
                while ci < len(cur) and want is not None and \
                        tuple(cur[ci].shape) != want:
                    ci += 1
                if ci >= len(cur):
                    raise ValueError(
                        f"optimizer state group '{pn}' (shape {want}) has "
                        "no positional parameter match — wrong "
                        "architecture?")
                mapping[pn] = id(cur[ci])
                ci += 1
            warnings.warn(
                f"optimizer state names {unmatched[:3]}... not found; "
                "matched saved slots to parameters by order and shape",
                stacklevel=2)
        shapes = {id(p): tuple(p.shape) for p in cur}
        by_param = {}
        for pn, slots in saved_slots.items():
            pid = mapping.get(pn)
            if pid is None:
                continue
            for slot, arr in slots.items():
                if arr.dim() and tuple(arr.shape) != shapes.get(pid):
                    raise ValueError(
                        f"optimizer slot '{pn}.{slot}' shape "
                        f"{tuple(arr.shape)} does not match parameter "
                        f"shape {shapes.get(pid)}")
            by_param[pid] = dict(slots)
        self._step_count = int(state.get("@step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        self._slots.update(by_param)

    set_dict = set_state_dict

    def _param_names(self):
        """A tensor's name: the one it was given in a (name, tensor) pair,
        else its parameter name (`param_name`, unique in the process, as
        the reference's `p.name`), else "param_{i}"."""
        return {id(p): self._names.get(id(p))
                or getattr(p, "param_name", None) or f"param_{i}"
                for i, p in enumerate(self._parameter_list or [])
                if p is not None}


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)

    def leaf_rule(self, p, g, s, lr, t, norm):
        p.sub_(lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, device=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def leaf_rule(self, p, g, s, lr, t, norm):
        v = s["velocity"]
        v.copy_(self._momentum * v + g)
        update = g + self._momentum * v if self._nesterov else v
        p.sub_(lr * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, name=None,
                 multi_precision=False, device=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def rule(self, params, grads, slots, lr, t, norms=None):
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


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01); the stateful
    `step` skips the decay of tensors `apply_decay_param_fun(name)`
    rejects."""

    decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, name=None, multi_precision=False,
                 device=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, name,
                         device=device)
        self._apply_decay_param_fun = apply_decay_param_fun

    def step(self):
        if self._apply_decay_param_fun is not None:
            names = self._param_names()
            for p in self._parameter_list or []:
                if p is not None:
                    p.no_weight_decay = not self._apply_decay_param_fun(
                        names[id(p)])
        super().step()


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def leaf_rule(self, p, g, s, lr, t, norm):
        b1, b2 = self._beta1, self._beta2
        m = s["moment"].copy_(b1 * s["moment"] + (1 - b1) * g)
        u = s["inf_norm"].copy_(torch.maximum(b2 * s["inf_norm"], g.abs()))
        p.sub_(lr / (1 - b1 ** t) * m / (u + self._eps))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, device=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def leaf_rule(self, p, g, s, lr, t, norm):
        acc = s["moment"].copy_(s["moment"] + g * g)
        p.sub_(lr * g / (torch.sqrt(acc) + self._eps))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._eps, self._rho = epsilon, rho

    def init_slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def leaf_rule(self, p, g, s, lr, t, norm):
        rho, eps = self._rho, self._eps
        asg = s["avg_squared_grad"].copy_(
            rho * s["avg_squared_grad"] + (1 - rho) * (g * g))
        update = -torch.sqrt((s["avg_squared_update"] + eps) / (asg + eps)) \
            * g
        s["avg_squared_update"].copy_(rho * s["avg_squared_update"]
                                      + (1 - rho) * (update * update))
        p.add_(lr * update)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_slots(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "momentum": torch.zeros_like(p)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p)
        return s

    def leaf_rule(self, p, g, s, lr, t, norm):
        rho = self._rho
        ms = s["mean_square"].copy_(rho * s["mean_square"]
                                    + (1 - rho) * (g * g))
        if self._centered:
            mg = s["mean_grad"].copy_(rho * s["mean_grad"] + (1 - rho) * g)
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = s["momentum"].copy_(self._momentum * s["momentum"]
                                  + lr * g / denom)
        p.sub_(mom)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None, name=None,
                 device=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device=device)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def leaf_rule(self, p, g, s, lr, t, norm):
        b1, b2 = self._beta1, self._beta2
        m = s["moment1"].copy_(b1 * s["moment1"] + (1 - b1) * g)
        v = s["moment2"].copy_(b2 * s["moment2"] + (1 - b2) * (g * g))
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._eps) + self._wd * p
        w_norm, r_norm = norm(p), norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.sub_(lr * trust * r)


class Lars(Optimizer):
    """LARS (the fleet's lars meta-optimizer wraps Momentum into it)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005, parameters=None,
                 grad_clip=None, name=None, device=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device=device)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay

    def init_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def leaf_rule(self, p, g, s, lr, t, norm):
        w_norm, g_norm = norm(p), norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._coeff * w_norm / (g_norm + self._wd * w_norm + 1e-12),
            torch.ones_like(w_norm))
        v = s["velocity"].copy_(self._momentum * s["velocity"]
                                + lr * local_lr * (g + self._wd * p))
        p.sub_(v)


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "L1Decay",
           "L2Decay"]
