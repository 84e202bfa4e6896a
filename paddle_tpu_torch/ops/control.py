"""Control flow: `cond`, `while_loop`, `case`, `switch_case`,
`increment_inplace`, `fori_loop`, `scan` (the port of
`paddle_tpu/ops/control.py`).

The port runs eagerly, so these are Python control flow over tensors:
a predicate or branch index is read on the host, which for a tensor on
the card is one device-to-host sync each time it is read (a `cond` or
`case` branch, every `while_loop` iteration). Branch functions take no
arguments and may close over tensors, as the reference's. The branches
not taken are not run; `case` with no `default` raises ValueError, as
the reference's does (it builds every branch).
"""
from __future__ import annotations

import torch


def _truth(pred):
    """A one-element predicate (tensor, array or Python value) as bool;
    a card tensor is read with one sync."""
    if torch.is_tensor(pred):
        return bool(pred.reshape(()).item())
    return bool(torch.as_tensor(pred).reshape(()).item())


def cond(pred, true_fn=None, false_fn=None, name=None):
    """true_fn() if pred else false_fn()."""
    fn = true_fn if _truth(pred) else false_fn
    return None if fn is None else fn()


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Run body_fn(*vars) -> new vars while cond_fn(*vars); returns the
    final vars as a list."""
    state = list(loop_vars)
    while _truth(cond_fn(*state)):
        out = body_fn(*state)
        state = list(out) if isinstance(out, (list, tuple)) else [out]
    return state


def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first (pred, fn) pair whose pred holds, else
    default()."""
    if default is None:
        raise ValueError("case: no default and no predicate matched "
                         "statically")
    for pred, fn in pred_fn_pairs:
        if _truth(pred):
            return fn()
    return default()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """branch_fns[index]() — a list, a dict {index: fn} or (index, fn)
    pairs; default (when given) is the last branch, and an index out of
    range is clipped into [0, branches - 1]."""
    if isinstance(branch_fns, dict):
        fns = [branch_fns.get(i, default) for i in range(max(branch_fns)
                                                         + 1)]
    else:
        fns = list(branch_fns)
        if fns and isinstance(fns[0], (tuple, list)):
            d = dict(fns)
            fns = [d.get(i, default) for i in range(max(d) + 1)]
    if default is not None:
        fns = fns + [default]
    idx = branch_index
    idx = int(idx.reshape(()).item()) if torch.is_tensor(idx) else int(idx)
    return fns[min(max(idx, 0), len(fns) - 1)]()


def increment_inplace(x, value=1.0):
    """x + value (a new tensor, as the reference's)."""
    return x + value


def fori_loop(lower, upper, body_fn, init):
    """s = body_fn(i, s) for i in range(lower, upper); returns s."""
    state = init
    for i in range(int(lower), int(upper)):
        state = body_fn(i, state)
    return state


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it)


def scan(f, init, xs):
    """carry, y = f(carry, x) over the leading axis of xs (a tensor or
    nested lists / tuples of tensors); returns (carry, ys stacked along
    a new leading axis)."""
    n = _leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        x = _rebuild(xs, iter([leaf[i] for leaf in _leaves(xs)]))
        carry, y = f(carry, x)
        ys.append(y)
    stacked = [torch.stack(col) for col in zip(*[_leaves(y) for y in ys])]
    return carry, _rebuild(ys[0], iter(stacked))


__all__ = ["cond", "while_loop", "case", "switch_case", "increment_inplace",
           "fori_loop", "scan"]
