"""Ulysses-style all-to-all sequence parallelism.

The port of `paddle_tpu/parallel/ulysses.py`: seq-sharded q, k, v
[B, H, S/n, D] become head-sharded [B, H/n, S, D] by one all-to-all
over `sp` (`comm.all_to_all`, differentiable), each rank runs a full-
sequence attention over its heads — the port's `flash_attention` when
the flash gate passes (K4, and K6 + K9 or K7 + K8 in the backward on the
card), else the reference's plain masked softmax — and a second
all-to-all restores seq sharding. `sp_attention` picks between Ulysses,
the ring and the zigzag ring by the reference's rule (`:72`).
"""
from __future__ import annotations

import torch

from . import comm
from .mesh import resolve_mesh


def _local_attention(q, k, v, causal, scale):
    from .ring_attention import _flash_ok
    if _flash_ok(q):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale)
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, logits.new_tensor(-1e30))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v).to(q.dtype)


def ulysses_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                      mesh=None):
    """q, k, v: [B, H, S_local, D] seq-sharded over `axis_name`. Returns
    [B, H, S_local, D]. Requires H % axis_size == 0."""
    mesh = resolve_mesh(mesh)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.size(axis_name)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by sp ({n}); "
            f"use ring attention for head counts below the sp degree")

    def seq_to_head(x):  # [B, H, S/n, D] -> [B, H/n, S, D]
        return comm.all_to_all(x, axis_name, 1, 2, mesh)

    def head_to_seq(x):  # [B, H/n, S, D] -> [B, H, S/n, D]
        return comm.all_to_all(x, axis_name, 2, 1, mesh)

    oh = _local_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                          causal, scale)
    return head_to_seq(oh)


def sp_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                 impl=None, mesh=None):
    """Sequence-parallel attention front door: impl = "ring" | "ulysses" |
    "zigzag" | None (auto: ulysses when every rank can own >= 1 head, else
    ring). "zigzag" needs the local shard in zigzag layout and a causal
    mask; it is never picked automatically."""
    from .ring_attention import ring_attention, zigzag_ring_attention
    mesh = resolve_mesh(mesh)
    if impl == "zigzag":
        if not causal:
            raise ValueError("zigzag layout only pays off under a causal "
                             "mask; use ring/ulysses for bidirectional")
        return zigzag_ring_attention(q, k, v, axis_name=axis_name,
                                     scale=scale, mesh=mesh)
    if impl is None:
        impl = "ulysses" if q.shape[1] % mesh.size(axis_name) == 0 \
            else "ring"
    if impl == "ulysses":
        return ulysses_attention(q, k, v, axis_name, causal, scale, mesh)
    return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                          scale=scale, mesh=mesh)


__all__ = ["ulysses_attention", "sp_attention"]
