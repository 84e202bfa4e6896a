"""Pipeline parallelism — GPipe and circular-interleaved schedules over
the `pp` mesh axis.

The port of `paddle_tpu/parallel/pipeline.py`, with its schedules and
bubble accounting. Every rank runs every tick: it computes its stage (or
chunk) on a fresh microbatch (the first stage) or on the activation the
previous rank sent last tick, then `comm.ppermute`s the result to the
next rank. Autograd runs the schedule backwards through the ppermutes'
backward, one chain a tick (the ticks' activations depend on each other
in order), so every rank issues its collectives in one order.

* GPipe (`pipeline_apply`): M + S - 1 ticks of one stage each; bubble
  fraction (S-1)/(M+S-1).
* Circular interleaved (`pipeline_apply_interleaved`): each rank holds V
  chunks (group l*S + r in chunk slot l of rank r) and a tick is one
  chunk; microbatch m's group v runs on rank v%S at tick
  (m//S)*V*S + (v//S)*S + (m%S) + (v%S); bubble (S-1)/(V*M+S-1).

The last stage's outputs reach every rank by the reference's masked sum
(`:84-86`), here `comm.reduce_from` (all-reduce forward, identity
backward): every rank then computes the same loss head, and each holds
its full gradient. The microbatches enter through `comm.copy_to`, so
when they depend on parameters every rank repeats (an embedding) the
first stage's gradient reaches every rank. With these two rules every
rank's gradients are complete without a reduction over pp.

Stage parameters are this rank's slice: `stage_slice` cuts them from the
global stack by the reference's specs (P("pp") for GPipe; [V*S, ...]
regrouped to [V, S, ...] and split on dim 1 for the interleaved
schedule).
"""
from __future__ import annotations

import torch

from . import comm
from .mesh import local_slice, resolve_mesh


def _ticks(stage_fn, params_at, microbatches, mesh, axis_name, ticks,
           schedule):
    """Run `ticks` ticks; schedule(t) -> (params, take_fresh, mb index,
    output slot or None) for this rank. Returns the [M, ...] outputs this
    rank stored and a zero scalar that depends on every tick it did not
    store: autograd prunes what the loss does not reach, per rank, and a
    tick pruned on one rank but not its neighbour would leave that
    neighbour's ppermute backward waiting; with the sink every rank's
    graph holds every tick."""
    m = microbatches.shape[0]
    mbs = comm.copy_to(microbatches, axis_name, mesh)
    buf = torch.zeros_like(microbatches[0])
    outs = [None] * m
    sink = microbatches.new_zeros(())
    for t in range(ticks):
        p, fresh_ok, mb_idx, out_idx = schedule(t)
        x = torch.where(torch.tensor(fresh_ok, device=buf.device),
                        mbs[mb_idx], buf)
        y = stage_fn(params_at(p), x)
        if out_idx is None:
            sink = sink + (y * 0).sum()
        else:
            outs[out_idx] = y
        if t < ticks - 1:
            buf = comm.ppermute(y, axis_name, mesh)
    stacked = torch.stack([o if o is not None else
                           torch.zeros_like(microbatches[0]) for o in outs])
    return stacked, sink


def _collect(stacked, sink, mesh, axis_name, is_last):
    """The last stage's [M, ...] outputs on every rank (masked sum)."""
    keep = torch.tensor(1.0 if is_last else 0.0, dtype=stacked.dtype,
                        device=stacked.device)
    return comm.reduce_from(stacked * keep + sink, axis_name, mesh)


def pipeline_apply(stage_fn, stage_params, microbatches, axis_name="pp",
                   mesh=None):
    """GPipe over `axis_name`. stage_fn(params, x) -> y is one stage;
    stage_params this rank's stage; microbatches [M, mb, ...], the same
    on every rank. Returns the last stage's [M, mb, ...] outputs on every
    rank."""
    mesh = resolve_mesh(mesh)
    s = mesh.size(axis_name)
    idx = mesh.axis_index(axis_name)
    m = microbatches.shape[0]

    def schedule(t):
        out_idx = t - (s - 1)
        # every rank stores what its last-stage slot would hold; only the
        # last rank's survive _collect's mask
        return None, idx == 0, min(t, m - 1), \
            (out_idx if out_idx >= 0 else None)

    stacked, sink = _ticks(stage_fn, lambda _p: stage_params, microbatches,
                           mesh, axis_name, m + s - 1, schedule)
    return _collect(stacked, sink, mesh, axis_name, idx == s - 1)


def pipeline_apply_interleaved(chunk_fn, chunk_params, microbatches,
                               axis_name="pp", mesh=None):
    """The circular-interleaved schedule. chunk_fn(params, x) -> y is one
    chunk; chunk_params a tensor, or a dict of tensors, whose leading dim
    is V: this rank's V chunks; microbatches [M, mb, ...] with M % S == 0. Returns the last
    group's [M, mb, ...] outputs on every rank."""
    mesh = resolve_mesh(mesh)
    s = mesh.size(axis_name)
    idx = mesh.axis_index(axis_name)
    m_total = microbatches.shape[0]
    if m_total % s:
        raise ValueError(
            f"interleaved schedule needs num_microbatches ({m_total}) "
            f"divisible by pp degree ({s})")
    single = torch.is_tensor(chunk_params)
    v_chunks = (chunk_params if single else
                next(iter(chunk_params.values()))).shape[0]
    ticks = v_chunks * m_total + s - 1

    def schedule(t):
        u = t - idx
        uc = max(u, 0)
        chunk_l = (uc % (v_chunks * s)) // s
        mb_idx = (uc // (v_chunks * s)) * s + uc % s
        valid = u >= 0 and mb_idx < m_total
        mb_c = min(mb_idx, m_total - 1)
        done = chunk_l == v_chunks - 1 and valid
        return chunk_l, idx == 0 and chunk_l == 0, mb_c, \
            (mb_c if done else None)

    def params_at(l):
        return chunk_params[l] if single else \
            {k: v[l] for k, v in chunk_params.items()}

    stacked, sink = _ticks(chunk_fn, params_at, microbatches, mesh,
                           axis_name, ticks, schedule)
    return _collect(stacked, sink, mesh, axis_name, idx == s - 1)


def stage_slice(params_stacked, mesh=None, schedule="gpipe", num_virtual=1,
                axis_name="pp", chunk_layers=None):
    """This rank's slice of a stacked {name: [G, ...]} dict: dim 0 split
    over the stages for GPipe ([G/S, ...]); for the interleaved schedule
    the layer-order groups regrouped [V, S, ...] — or [V, S, chunk_layers,
    ...] when a chunk holds several layers — and split on dim 1
    ([V, 1, ...]: chunk l*S + r on rank r)."""
    mesh = resolve_mesh(mesh)
    s = mesh.size(axis_name)
    out = {}
    for k, p in params_stacked.items():
        if schedule == "interleaved" and num_virtual > 1:
            lead = (num_virtual, s) + (() if chunk_layers is None else
                                       (chunk_layers,))
            p = p.reshape(lead + tuple(p.shape[1:]))
            spec = (None, axis_name)
        else:
            spec = (axis_name,)
        out[k] = local_slice(p, spec, mesh.coords, mesh.shape)
    return out


def make_pipeline_loss(stage_fn, loss_head, mesh, num_microbatches,
                       axis_name="pp", schedule="gpipe", num_virtual=1):
    """loss(params_local, x, labels) running the selected schedule over
    `axis_name` of `mesh`. params_local is this rank's slice
    (`stage_slice`): a dict (or one tensor) whose leaves are [1, ...]
    (gpipe) or [V, 1, ...] (interleaved). loss_head(y_last, labels) ->
    scalar runs on every rank; the loss is the same on all of them."""
    if schedule not in ("gpipe", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    interleaved = schedule == "interleaved" and num_virtual > 1

    def loss_fn(params_local, x, labels):
        single = torch.is_tensor(params_local)
        m = num_microbatches
        mbs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        if interleaved:
            chunks = params_local[:, 0] if single else \
                {k: v[:, 0] for k, v in params_local.items()}
            outs = pipeline_apply_interleaved(stage_fn, chunks, mbs,
                                              axis_name, mesh)
        else:
            stage = params_local[0] if single else \
                {k: v[0] for k, v in params_local.items()}
            outs = pipeline_apply(stage_fn, stage, mbs, axis_name, mesh)
        y = outs.reshape((x.shape[0],) + tuple(outs.shape[2:]))
        return loss_head(y, labels)

    return loss_fn


def bubble_fraction(schedule, num_stages, num_microbatches, num_virtual=1):
    """Analytic idle fraction of each schedule: gpipe (S-1)/(M+S-1);
    interleaved (S-1)/(V*M+S-1)."""
    s, m, v = num_stages, num_microbatches, num_virtual
    if schedule == "gpipe":
        return (s - 1) / (m + s - 1)
    if schedule == "interleaved":
        return (s - 1) / (v * m + s - 1)
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


__all__ = ["pipeline_apply", "pipeline_apply_interleaved",
           "make_pipeline_loss", "bubble_fraction", "stage_slice"]
