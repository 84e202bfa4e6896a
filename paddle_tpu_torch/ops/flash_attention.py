"""Flash attention of the training path, with its autograd rule.

The port of `paddle_tpu/ops/pallas/flash_attention.py`'s unbiased path:

  * `flash_fwd_lse(q, k, v, scale, causal)` -> (out, lse) — K4;
  * `flash_delta(o, do)` -> delta = rowsum(dO * O) — K6;
  * `flash_bwd(q, k, v, o, lse, do, scale, causal)` -> (dq, dk, dv) —
    K6 then K9, the fused one-pass backward;
  * `FlashAttention`, the `torch.autograd.Function` over them (K10: the
    forward saves q, k, v, out and lse; the backward launches K6 then K9),
    and `flash_attention(q, k, v, causal, scale)`.

Layouts are the reference's: q [B, H, Sq, D], k/v [B, H, Sk, D]. The LSE
and delta are [B*H, Sq] float32 — the TPU kernels broadcast them over 8
lanes for their tile layout, which the port drops (ring attention, when
it is ported, reads this layout).

Dispatch is by device: CUDA tensors launch the Hopper kernels
(`ops.kernels`, which raise on anything they do not take), CPU tensors
run the plain versions below. There is no fallback from a kernel to its
plain version.

Causal masking is bottom-right aligned (query i sees key j iff
j <= i + Sk - Sq), as the reference's `_reference_attention` and XLA
path; the TPU kernels align top-left, and the two agree when Sq == Sk. A
causal row that sees no key (Sq > Sk) gets what the reference's -1e30
fill gives it: the uniform average of all values, and no gradient to q
or k. The plain versions compute in float32 and round only their
outputs, as the kernels do. The per-key bias variant
(`flash_attention_bias`) belongs to the BERT slice.
"""
from __future__ import annotations

import torch

from . import kernels

NEG_INF = -1e30


def _on_card(*tensors):
    """True -> launch the kernels (CUDA tensors); False -> the plain
    versions (CPU tensors). Any other device mix is refused."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"flash attention operands span devices: "
                             f"{dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no flash attention path for device {dev}")


def _scale(q, scale):
    return (q.shape[-1] ** -0.5) if scale is None else float(scale)


def _visible(sq, sk, causal, device):
    """[sq, sk] bool mask of the keys each query sees (bottom-right
    causal), and the [sq] rows that see none."""
    if not causal:
        return (torch.ones(sq, sk, dtype=torch.bool, device=device),
                torch.zeros(sq, dtype=torch.bool, device=device))
    vis = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)
    return vis, ~vis.any(-1)


def _scores(q, k, scale, causal):
    """float32 scores [B, H, Sq, Sk] with the reference's -1e30 fill."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    vis, _ = _visible(q.shape[2], k.shape[2], causal, q.device)
    return s.masked_fill(~vis, NEG_INF)


def flash_fwd_lse_plain(q, k, v, scale, causal):
    """The plain version of K4: `_reference_attention` plus the LSE.
    Returns (out in q's dtype, lse [B*H, Sq] float32)."""
    B, H, Sq, _ = q.shape
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    # softmax, not exp(s - lse): a row of -1e30 fills has lse == -1e30 in
    # float32 (log Sk is below its last bit) and must still average
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
    return out.to(q.dtype), lse.reshape(B * H, Sq)


def flash_delta_plain(o, do):
    """The plain version of K6: rowsum(dO * O) in float32, [B*H, S]."""
    B, H, S, _ = o.shape
    return (o.float() * do.float()).sum(-1).reshape(B * H, S)


def flash_bwd_plain(q, k, v, do, lse, delta, scale, causal):
    """The plain version of K9 (with the same tile math as its
    `tile_p_ds`): p = exp(s - lse) from the stored LSE, ds = p * (dO.v -
    delta), zero where masked; a row that sees no key has p = 1/Sk and
    ds = 0. Returns (dq, dk, dv) in the inputs' dtype."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    vis, dead = _visible(Sq, Sk, causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(B, H, Sq, 1))
    fill = torch.where(dead[:, None], 1.0 / Sk, 0.0)
    p = torch.where(vis, p, fill)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = torch.where(vis, p * (dp - delta.reshape(B, H, Sq, 1)), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd_lse(q, k, v, scale=None, causal=False):
    """Attention forward with the per-row LSE: (out [B, H, Sq, D] in q's
    dtype, lse [B*H, Sq] float32). K4 on the card."""
    sc = _scale(q, scale)
    if _on_card(q, k, v):
        return kernels.flash_fwd(q, k, v, sc, causal)
    return flash_fwd_lse_plain(q, k, v, sc, causal)


def flash_delta(o, do):
    """delta = rowsum(dO * O) in float32, [B*H, Sq]. K6 on the card."""
    if _on_card(o, do):
        return kernels.flash_delta(o, do)
    return flash_delta_plain(o, do)


def flash_bwd(q, k, v, o, lse, do, scale=None, causal=False):
    """The backward given the forward's out and lse and the cotangent
    do: (dq, dk, dv). K6 then K9 on the card."""
    sc = _scale(q, scale)
    delta = flash_delta(o, do)
    if _on_card(q, k, v, do, lse, delta):
        return kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
    return flash_bwd_plain(q, k, v, do, lse, delta, sc, causal)


class FlashAttention(torch.autograd.Function):
    """The reference's custom-vjp `flash_attention`: the forward keeps
    q, k, v, out and lse; the backward is K6 + K9 (their plain versions
    on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd_lse(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(), ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over q [B, H, Sq, D], k/v
    [B, H, Sk, D]; scale defaults to D**-0.5. Inputs are made contiguous
    (the kernels read contiguous rows)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal),
                                _scale(q, scale))


__all__ = ["flash_attention", "FlashAttention", "flash_fwd_lse",
           "flash_delta", "flash_bwd", "flash_fwd_lse_plain",
           "flash_delta_plain", "flash_bwd_plain"]
