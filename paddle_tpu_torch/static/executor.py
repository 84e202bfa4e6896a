"""Executor: runs a Program, the port of `paddle_tpu/static/executor.py`.

Replay. `run` walks the Program's op list on the device of its place
(the default device when none is given) and calls each op's torch
callable on real tensors: the feeds, the persistables of the `Scope`,
and the op's constants (moved to that device once and kept). It is the
eager code the Program was recorded from, so the port's kernels launch
as they would eagerly (the flash forward and backward are registered
ops: one node each). Stochastic ops draw fresh numbers at each run.

Training. With optimizers (`Optimizer.minimize` in static mode), one
forward runs for all of them, each loss's gradients are taken with
`torch.autograd.grad` at the pre-update parameters, and the updates are
applied in program order by the optimizers' `functional_update` (in
place, on the Scope's tensors; a later optimizer sharing a parameter
reads the updated value), as the reference composes its minimize calls
(`executor.py:180-190`). A `<name>@GRAD` fetch gives that gradient; it
works without an optimizer too, after `append_backward` or `gradients`,
for parameters and data alike.

The cache keys on the Program's uid and version, the feeds' shapes and
dtypes, the fetches and the optimizer count, as the reference's compiled
steps do; an entry holds the op list's constants on the device.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve_device
from .program import Variable, default_main_program


def _debug_logger():
    from ..observability import log as _log
    return _log.get_logger(__name__)


class Scope:
    """The persistables of a Program: {name: tensor}."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        return self._vars.setdefault(name, None)

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()

    def __contains__(self, name):
        return name in self._vars


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def _name(v):
    if isinstance(v, Variable):
        return v.name
    return f"<constant {id(v)}>" if torch.is_tensor(v) else str(v)


class _Constants:
    """An op list's constant tensors on one device, moved once."""

    def __init__(self, device):
        self.device = device
        self._moved = {}

    def get(self, op, i, value):
        if not isinstance(value, torch.Tensor) or value.device == self.device:
            return value
        key = (id(op), i)
        got = self._moved.get(key)
        if got is None:
            got = self._moved[key] = value.detach().to(self.device)
        return got


def prune(program, targets):
    """The ops of the Program that the Variables named `targets` need, in
    program order (the reference's prune of an inference program)."""
    need, ops = set(targets), []
    for op in reversed(program.global_block().ops):
        if any(v.name in need for v in op.out_vars):
            ops.append(op)
            need.update(p.name for kind, p in op.leaves if kind == "var")
    return ops[::-1]


def forward_env(program, values, consts, ops=None):
    """Replay the op list (or `ops`, a pruned part of it) over {name:
    tensor} `values` (parameters and feeds); returns the environment
    {name: tensor} of every Variable."""
    env = dict(values)
    for op in (program.global_block().ops if ops is None else ops):
        vals = []
        for i, (kind, payload) in enumerate(op.leaves):
            if kind == "var":
                if payload.name not in env:
                    raise KeyError(f"variable {payload.name!r} used before "
                                   f"definition (op {op.type})")
                vals.append(env[payload.name])
            else:
                vals.append(consts.get(op, i, payload))
        args, kwargs = pytree.tree_unflatten(vals, op.treedef)
        out = op.fn(*args, **kwargs)
        for (kind, v), o in zip(op.out_leaves, pytree.tree_leaves(out)):
            if kind == "var":
                env[v.name] = o
    return env


def _to_device(val, device):
    if isinstance(val, torch.Tensor):
        return val.detach().to(device)
    arr = np.asarray(val)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Executor:
    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache = {}

    def close(self):
        self._cache.clear()

    def _init_persistables(self, program, scope):
        for var, init in program.initializers:
            if scope.find_var(var.name) is None:
                scope.set(var.name, self._initial(var, init))
        return []

    def _initial(self, var, init):
        from ..nn import initializer as I
        fn = init or I.XavierUniform()
        with torch.no_grad():
            return fn(tuple(var.shape), var.dtype, device=self.device)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        program = program if program is not None else default_main_program()
        from .io import LoadedProgram
        if isinstance(program, LoadedProgram):  # a deserialized artifact
            outs = program(feed or {})
            if fetch_list:
                idx = {n: i for i, n in enumerate(program.fetch_names)}
                outs = [outs[idx[_name(v)]] for v in fetch_list]
            return [_numpy(o) for o in outs] if return_numpy else outs
        if hasattr(program, "_program"):  # CompiledProgram
            program = program._program
        scope = scope if scope is not None else _global_scope
        # a startup program: run the initializers into the scope
        if program.initializers and not program.global_block().ops \
                and program._loss is None:
            return self._init_persistables(program, scope)

        fetch_names = [_name(v) for v in (fetch_list or [])]
        feed_vals = {n: _to_device(v, self.device)
                     for n, v in (feed or {}).items()}
        persist = [v for v in program.global_block().vars.values()
                   if v.persistable]
        for v in persist:  # a persistable that startup did not cover
            if scope.find_var(v.name) is None and v.initializer is not None:
                scope.set(v.name, self._initial(v, v.initializer))
        params = {v.name: scope.find_var(v.name) for v in persist
                  if scope.find_var(v.name) is not None}

        key = (program._uid, program._version,
               tuple(sorted((n, tuple(t.shape), t.dtype)
                            for n, t in feed_vals.items())),
               tuple(fetch_names), len(program._optimizers), self.device)
        consts = self._cache.get(key) if use_program_cache else None
        if consts is None:
            consts = _Constants(self.device)
            if use_program_cache:
                self._cache[key] = consts

        if program._optimizers:
            env = self._train(program, scope, params, feed_vals, consts)
        else:
            env = self._forward(program, params, feed_vals, fetch_names,
                                consts)
        fetches = []
        for v, n in zip(fetch_list or [], fetch_names):
            if torch.is_tensor(v) and not isinstance(v, Variable):
                fetches.append(v)  # a constant of the Program
            elif n not in env:
                raise KeyError(f"fetch target {n!r} not produced")
            else:
                fetches.append(env[n])
        if return_numpy:
            return [_numpy(f) for f in fetches]
        return [f.detach() for f in fetches]

    def _forward(self, program, params, feed_vals, fetch_names, consts):
        targets = [n[:-len("@GRAD")] for n in fetch_names
                   if n.endswith("@GRAD")]
        loss = program._loss
        if not (targets and loss is not None):
            with torch.no_grad():
                return forward_env(program, {**params, **feed_vals}, consts)
        # append_backward / gradients() without an optimizer: the marked
        # loss differentiated by the targets, parameters or feeds alike
        values = {**params, **feed_vals}
        leaves = {n: values[n].detach().requires_grad_(True)
                  for n in targets}
        values.update(leaves)
        env = forward_env(program, values, consts)
        grads = torch.autograd.grad(env[loss.name], list(leaves.values()),
                                    allow_unused=True)
        for n, g in zip(leaves, grads):
            env[n + "@GRAD"] = torch.zeros_like(leaves[n]) if g is None \
                else g
        return env

    def _train(self, program, scope, params, feed_vals, consts):
        states = []
        for i, (opt, _loss, ps) in enumerate(program._optimizers):
            # program-scoped: two programs sharing one key would share
            # Adam moments across their parameters
            sname = f"@opt_state_{program._uid}_{i}"
            st = scope.find_var(sname)
            if st is None:
                st = opt.functional_init({p.name: params[p.name]
                                          for p in ps})
                scope.set(sname, st)
            states.append(st)
        trainable = {p.name for _, _, ps in program._optimizers for p in ps}
        values = {**params, **feed_vals}
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in trainable}
        values.update(leaves)
        # one forward; every backward at the pre-update parameters
        env = forward_env(program, values, consts)
        all_grads = []
        last = len(program._optimizers) - 1
        for i, (opt, loss, ps) in enumerate(program._optimizers):
            gs = torch.autograd.grad(env[loss.name],
                                     [leaves[p.name] for p in ps],
                                     retain_graph=i < last,
                                     allow_unused=True)
            all_grads.append({p.name: (torch.zeros_like(params[p.name])
                                       if g is None else g)
                              for p, g in zip(ps, gs)})
        env = {n: (t.detach() if isinstance(t, torch.Tensor) else t)
               for n, t in env.items()}
        # the updates, in program order, in place on the scope's tensors
        for (opt, _loss, ps), grads, st in zip(program._optimizers,
                                               all_grads, states):
            clip = opt._grad_clip
            if clip is not None and hasattr(clip, "clip_tree"):
                grads = clip.clip_tree(grads)
            opt.functional_update({p.name: params[p.name] for p in ps},
                                  grads, st, lr=opt.get_lr())
            for n, g in grads.items():
                env[n + "@GRAD"] = g
        return env

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Run the Program once a batch of a fluid Dataset (ref:
        executor.py train_from_dataset, the C++ MultiTrainer)."""
        if dataset is None:
            raise ValueError("dataset is required")
        program = program if program is not None else default_main_program()
        feed_names = {v.name for v in program.global_block().vars.values()
                      if not v.persistable}
        for step, batch in enumerate(dataset):
            feed = {n: v for n, v in batch.items() if n in feed_names} \
                or dict(batch)
            outs = self.run(program, feed=feed, fetch_list=fetch_list,
                            scope=scope)
            if debug and fetch_list and step % max(print_period, 1) == 0:
                labels = fetch_info or [_name(v) for v in fetch_list]
                msg = ", ".join(f"{lbl}={np.asarray(o).ravel()[:4]}"
                                for lbl, o in zip(labels, outs))
                _debug_logger().info("step %s: %s", step, msg)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """train_from_dataset with the Program's optimizers suspended, so
        evaluation never moves the weights (ref: infer_from_dataset)."""
        program = program if program is not None else default_main_program()
        saved = program._optimizers
        program._optimizers = []
        try:
            return self.train_from_dataset(program, dataset, scope, thread,
                                           debug, fetch_list, fetch_info,
                                           print_period)
        finally:
            program._optimizers = saved


__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "forward_env", "prune"]
