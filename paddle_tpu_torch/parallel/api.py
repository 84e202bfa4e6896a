"""Sharding rules and the sharded train step.

The port of `paddle_tpu/parallel/api.py`. The reference returns
`NamedSharding`s and lets XLA place arrays and insert collectives; in the
port each rank holds the local slice a spec gives it (`mesh.local_slice`)
and the gradient reductions are explicit (`sharded_train_step`).
"""
from __future__ import annotations

import re

import torch

from . import comm
from .mesh import P, local_slice, resolve_mesh


def replicate(mesh=None):
    """The spec of a replicated leaf."""
    return P()


def shard_batch(mesh, x, axis=0):
    """This rank's dp slice of the global batch `x` along `axis`."""
    spec = [None] * x.dim()
    spec[axis] = "dp"
    return local_slice(x, spec, mesh.coords, mesh.shape)


def data_parallel_shardings(mesh, params_tree, batch_tree):
    """Pure dp: params replicated, batch split on dp (specs)."""
    return ({k: P() for k in params_tree},
            {k: P("dp", *([None] * (v.dim() - 1)))
             for k, v in batch_tree.items()})


# Megatron-style tensor-parallel rules for transformer params, keyed by
# parameter-name regex -> spec factory (rank-dependent)
_TP_RULES = [
    (re.compile(r"(q_proj|k_proj|v_proj|qkv|fc1|gate|up_proj|w1|w3)"
                r".*weight$"), lambda nd: P(*([None] * (nd - 1) + ["mp"]))),
    (re.compile(r"(q_proj|k_proj|v_proj|qkv|fc1|gate|up_proj|w1|w3)"
                r".*bias$"), lambda nd: P("mp")),
    (re.compile(r"(out_proj|fc2|down_proj|w2|proj)"
                r".*weight$"), lambda nd: P(*(["mp"] + [None] * (nd - 1)))),
    (re.compile(r"(embedding|embed_tokens|word_emb).*weight$"),
     lambda nd: P("mp", *([None] * (nd - 1)))),
    (re.compile(r"lm_head.*weight$"),
     lambda nd: P(*([None] * (nd - 1) + ["mp"]))),
]


def tp_spec_for(name, ndim):
    for rx, fac in _TP_RULES:
        if rx.search(name):
            return fac(ndim)
    return P()


def shard_params_tp(mesh, named_params):
    """named_params {name: global tensor} -> {name: this rank's slice}
    by the Megatron column/row rules (everything else replicated)."""
    return {name: local_slice(v, tp_spec_for(name, v.dim()), mesh.coords,
                              mesh.shape)
            for name, v in named_params.items()}


def sharded_train_step(loss_fn, mesh, optimizer, reduce_axes=("dp", "sp"),
                       axes_of=None):
    """step(params, opt_state, batch) -> (loss, params, opt_state).

    loss_fn(params, batch) runs on this rank's params and batch and returns
    the global loss (the caller's `comm.mean_over` of its local mean, as
    `build_hybrid_gpt2_loss` does). Each gradient is then summed over the
    axes on which its leaf is replicated while the data is split
    (`reduce_axes`, or `axes_of(name)` per leaf) and `optimizer`'s
    functional update runs on the local leaves, in place."""
    mesh = resolve_mesh(mesh)
    if axes_of is None:
        def axes_of(_name):
            return reduce_axes

    def step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        comm.reduce_gradients(grads, axes_of, mesh)
        params, opt_state = optimizer.functional_update(params, grads,
                                                        opt_state)
        return loss.detach(), params, opt_state

    return step


__all__ = ["replicate", "shard_batch", "data_parallel_shardings",
           "tp_spec_for", "shard_params_tp", "sharded_train_step"]
