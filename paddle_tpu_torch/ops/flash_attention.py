"""Flash attention of the training path, with its autograd rules.

The port of `paddle_tpu/ops/pallas/flash_attention.py`:

  * `flash_fwd_lse(q, k, v, scale, causal, bias=None)` -> (out, lse) —
    K4, or K4 bias with a per-key bias;
  * `flash_delta(o, do)` -> delta = rowsum(dO * O) — K6;
  * `flash_bwd(q, k, v, o, lse, do, scale, causal, bias=None)` ->
    (dq, dk, dv, dbias) — K6 then K9 (K9 bias), the fused one-pass
    backward; dbias is None without a bias, else in the bias's shape;
  * `flash_bwd_two_pass(q, k, v, o, lse, do, scale, causal, bias=None)`
    -> (dq, dk, dv, dbias) — K6 then K7 (dq) and K8 (dk, dv, dbias), the
    reference's `_flash_bwd`. p comes from the LSE it is given, never
    renormalised over these keys, so ring attention can pass the global
    LSE and the global output while k/v are one block of keys. No atomics:
    bitwise reproducible on the card;
  * `uses_two_pass(sq, d)`: the reference's switch between them, word for
    word (`_fa_bwd`/`_fab_bwd`: the fused backward while
    sq * d * 10 <= 8 MB, else the two-pass one). It is the TPU's VMEM
    budget, not a Hopper limit (K9 takes any length), kept so that port
    and reference run the same kernels at every shape: at D = 64 the
    two-pass backward starts at sq = 13108;
  * `flash_attn_op` (`torch.ops.paddle_tpu_torch.flash_attn`) and
    `flash_attn_bwd_op` (`...flash_attn_bwd`): the forward and the
    backward as registered ops (K10, the reference's custom vjp: the
    forward's autograd rule keeps q, k, v, the bias, out and lse, and
    calls the backward op, K6 + K9, or K6 + K7 + K8 when `uses_two_pass`
    holds). Each op is one node to a static Program and to
    `torch.export`; its fake implementation gives the shapes. An eager
    call on plain tensors goes through `_FlashAttention`, the same
    forward and backward as an `autograd.Function`, which costs less
    host time a call. `flash_attention(q, k, v, causal, scale)` takes
    them without a bias;
  * `flash_attention_bias(q, k, v, bias, causal, scale)` with a
    per-key additive bias [B or 1, Sk] (the [B, 1, 1, Sk] padding mask of
    BERT-class encoders), whose cotangent is the column sums of ds summed
    over heads, and over the batch when the bias broadcasts
    (`_fab_bwd`, `flash_attention.py:721-741`).

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
or k (nor to a bias, which such a row ignores). The bias is added to
s * scale before the softmax. A FULLY MASKED row — every key it sees
carries a -1e30 bias, e.g. a padded batch row with no real token — gets
what the reference's XLA path (`_xla_attention` + autodiff) gives it:
uniform weights over the keys it sees, and the gradients of softmax at
those weights, which reach q, k and the bias. Its LSE rounds to -1e30 in
float32, so the backward marks it by lse <= -1e29 and uses p = 1 / (keys
it sees); the reference's own Pallas backward recomputes p = 1 there and
is off by that factor. The plain versions compute in float32 and round
only their outputs, as the kernels do; dbias is summed in float32 (the
reference casts ds to k's dtype before its column sums).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels

NEG_INF = -1e30
MASKED_LSE = -1e29  # an LSE at or below it marks a fully masked row


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


def _bias4(bias):
    """[B or 1, Sk] -> float32 [B or 1, 1, 1, Sk], or 0 without a bias."""
    return 0.0 if bias is None else bias.float()[:, None, None, :]


def _scores(q, k, scale, causal, bias=None):
    """float32 scores [B, H, Sq, Sk]: s * scale + bias where the query
    sees the key, -inf where it does not, and the reference's -1e30
    everywhere in a row that sees no key."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale \
        + _bias4(bias)
    vis, dead = _visible(q.shape[2], k.shape[2], causal, q.device)
    return s.masked_fill(~vis, -torch.inf).masked_fill(dead[:, None],
                                                        NEG_INF)


def flash_fwd_lse_plain(q, k, v, scale, causal, bias=None):
    """The plain version of K4 (K4 bias with a [B or 1, Sk] bias):
    `_reference_attention` plus the LSE. Returns (out in q's dtype, lse
    [B*H, Sq] float32)."""
    B, H, Sq, _ = q.shape
    s = _scores(q, k, scale, causal, bias)
    lse = torch.logsumexp(s, dim=-1)
    # softmax, not exp(s - lse): a row of -1e30 scores has lse == -1e30
    # in float32 (log Sk is below its last bit) and must still average
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
    return out.to(q.dtype), lse.reshape(B * H, Sq)


def flash_delta_plain(o, do):
    """The plain version of K6: rowsum(dO * O) in float32, [B*H, S]."""
    B, H, S, _ = o.shape
    return (o.float() * do.float()).sum(-1).reshape(B * H, S)


def _p_ds(q, k, v, do, lse, delta, scale, causal, bias):
    """The backward's tile math of every backward kernel, in one place
    (their `tile_p_ds`, the reference's `_tile_p_ds`): float32 (p, ds)
    [B, H, Sq, Sk] with p = exp(s * scale + bias - lse) from the LSE given
    (never renormalised over these keys) and ds = p * (dO.v - delta), zero
    where masked; a row that sees no key has p = 1/Sk and ds = 0; a fully
    masked row (lse <= -1e29) has p = 1 / (keys it sees)."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    vis, dead = _visible(Sq, Sk, causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale \
        + _bias4(bias)
    lse4 = lse.reshape(B, H, Sq, 1)
    p = torch.where(lse4 <= MASKED_LSE, 1.0 / vis.sum(-1, keepdim=True),
                    torch.exp(s - lse4))
    fill = torch.where(dead[:, None], 1.0 / Sk, 0.0)
    p = torch.where(vis, p, fill)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = torch.where(vis, p * (dp - delta.reshape(B, H, Sq, 1)), 0.0)
    return p, ds


def _dq(ds, k, scale):
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale


def _dkv(p, ds, q, do, scale, bias):
    """(dk, dv) in float32 and dbias [B*H, Sk] float32 (the column sums
    of ds; None without a bias)."""
    B, H, _, Sk = ds.shape
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dbias = None if bias is None else ds.sum(2).reshape(B * H, Sk)
    return dk, dv, dbias


def flash_bwd_plain(q, k, v, do, lse, delta, scale, causal, bias=None):
    """The plain version of K9 and K9 bias (`_p_ds`, then the three
    products). Returns (dq, dk, dv) in the inputs' dtype and dbias
    [B*H, Sk] float32 (None without a bias)."""
    p, ds = _p_ds(q, k, v, do, lse, delta, scale, causal, bias)
    dk, dv, dbias = _dkv(p, ds, q, do, scale, bias)
    return (_dq(ds, k, scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dbias)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, bias=None):
    """The plain version of K7 and K7 bias: dq = scale * ds k in q's
    dtype, from the same `_p_ds` as K9's."""
    _p, ds = _p_ds(q, k, v, do, lse, delta, scale, causal, bias)
    return _dq(ds, k, scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal, bias=None):
    """The plain version of K8 and K8 bias: (dk, dv) in k/v's dtype and
    dbias [B*H, Sk] float32 (None without a bias), from the same `_p_ds`
    as K9's."""
    p, ds = _p_ds(q, k, v, do, lse, delta, scale, causal, bias)
    dk, dv, dbias = _dkv(p, ds, q, do, scale, bias)
    return dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_fwd_lse(q, k, v, scale=None, causal=False, bias=None):
    """Attention forward with the per-row LSE: (out [B, H, Sq, D] in q's
    dtype, lse [B*H, Sq] float32). K4 on the card; K4 bias with a
    per-key bias [B or 1, Sk] float32."""
    sc = _scale(q, scale)
    if not _on_card(q, k, v, *(() if bias is None else (bias,))):
        return flash_fwd_lse_plain(q, k, v, sc, causal, bias)
    if bias is None:
        return kernels.flash_fwd(q, k, v, sc, causal)
    return kernels.flash_fwd_bias(q, k, v, bias, sc, causal)


def flash_delta(o, do):
    """delta = rowsum(dO * O) in float32, [B*H, Sq]. K6 on the card."""
    if _on_card(o, do):
        return kernels.flash_delta(o, do)
    return flash_delta_plain(o, do)


def _sum_dbias(db, q, bias):
    """The kernels' per-(batch, head) dbias [B*H, Sk] summed over heads,
    and over the batch when the bias broadcasts (the reference's
    `_fab_bwd`): float32 in the bias's shape, or None without one."""
    if db is None:
        return None
    db = db.reshape(q.shape[0], q.shape[1], -1).sum(1)
    return db.sum(0, keepdim=True) if bias.shape[0] == 1 else db


def uses_two_pass(sq, d):
    """True when the reference's backward takes the two-pass `_flash_bwd`
    over the fused `_flash_bwd_fused`: its expression, word for word
    (`_fa_bwd`/`_fab_bwd`, a TPU VMEM budget on q's length and width)."""
    return not sq * d * 10 <= 8 * 1024 * 1024


def flash_bwd(q, k, v, o, lse, do, scale=None, causal=False, bias=None):
    """The backward given the forward's out and lse and the cotangent
    do: (dq, dk, dv, dbias). K6 then K9 on the card, K9 bias with a
    bias; dbias is None without a bias, else float32 in the bias's shape:
    the kernel's per-(batch, head) column sums summed over heads, and over
    the batch when the bias broadcasts (the reference's `_fab_bwd`)."""
    sc = _scale(q, scale)
    delta = flash_delta(o, do)
    if not _on_card(q, k, v, do, lse, delta,
                    *(() if bias is None else (bias,))):
        dq, dk, dv, db = flash_bwd_plain(q, k, v, do, lse, delta, sc, causal,
                                         bias)
    elif bias is None:
        (dq, dk, dv), db = kernels.flash_bwd(q, k, v, do, lse, delta, sc,
                                             causal), None
    else:
        dq, dk, dv, db = kernels.flash_bwd_bias(q, k, v, do, lse, delta,
                                                bias, sc, causal)
    return dq, dk, dv, _sum_dbias(db, q, bias)


def flash_bwd_two_pass(q, k, v, o, lse, do, scale=None, causal=False,
                       bias=None):
    """The two-pass backward (the reference's `_flash_bwd`): (dq, dk, dv,
    dbias) as `flash_bwd` returns them. K6 then K7 and K8 on the card (K7
    bias and K8 bias with a bias), `flash_bwd_plain` on the CPU. lse
    and o may be those of a larger attention than k/v's keys (ring
    attention passes the global ones): p is exp(s * scale + bias - lse)
    over these keys, never renormalised."""
    sc = _scale(q, scale)
    delta = flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    if not _on_card(*args, *(() if bias is None else (bias,))):
        # K7 + K8's plain versions together are K9's, bit for bit
        dq, dk, dv, db = flash_bwd_plain(*args, sc, causal, bias)
    elif bias is None:
        dq = kernels.flash_bwd_dq(*args, sc, causal)
        (dk, dv), db = kernels.flash_bwd_dkv(*args, sc, causal), None
    else:
        dq = kernels.flash_bwd_dq_bias(*args, bias, sc, causal)
        dk, dv, db = kernels.flash_bwd_dkv_bias(*args, bias, sc, causal)
    return dq, dk, dv, _sum_dbias(db, q, bias)


def _backward(q, k, v, out, lse, g, scale, causal, bias=None):
    """The autograd rules' backward: the reference's switch between the
    fused and the two-pass backward, on q's length and width."""
    bwd = flash_bwd_two_pass if uses_two_pass(q.shape[2], q.shape[3]) \
        else flash_bwd
    return bwd(q, k, v, out, lse, g.contiguous(), scale, causal, bias)


# The flash forward and its backward are registered ops of the
# `paddle_tpu_torch` namespace (`torch.library.custom_op`), so that a static
# Program and `torch.export` (`jit.save`) each see one node per attention
# call. Each op's implementation is the device dispatch above (the kernels on
# a CUDA tensor, the plain versions on a CPU tensor); a fake implementation
# gives the output shapes; the forward's autograd rule calls the backward op.
# An eager call on plain tensors takes `_FlashAttention` instead: the same
# implementations and the same kernels, without the registered op's
# per-call dispatch, which costs an eager step host time
# (scripts/torch_flash_dispatch_ab.py measures it).


@torch.library.custom_op("paddle_tpu_torch::flash_attn", mutates_args=())
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K4, or K4 bias with a float32 [B or 1, Sk] bias: (out, lse)."""
    return flash_fwd_lse(q, k, v, scale, causal, bias)


@flash_attn_op.register_fake
def _flash_attn_fake(q, k, v, bias, causal, scale):
    B, H, Sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B * H, Sq), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_attn_bwd", mutates_args=())
def flash_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], out: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor, causal: bool,
                      scale: float) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, dbias): K6 + K9 (bias), or K6 + K7 + K8 (bias) when
    `uses_two_pass` holds. dbias is float32 in the bias's shape, and an
    empty tensor without a bias (an op returns tensors only)."""
    dq, dk, dv, db = _backward(q, k, v, out, lse, g, scale, causal, bias)
    return dq, dk, dv, q.new_empty(0, dtype=torch.float32) if db is None \
        else db


@flash_attn_bwd_op.register_fake
def _flash_attn_bwd_fake(q, k, v, bias, out, lse, g, causal, scale):
    db = q.new_empty(0, dtype=torch.float32) if bias is None \
        else torch.empty_like(bias, dtype=torch.float32)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), db


def _flash_attn_setup(ctx, inputs, output):
    q, k, v, bias, causal, scale = inputs
    ctx.save_for_backward(q, k, v, bias, *output)
    ctx.causal, ctx.scale = causal, scale


def _flash_attn_backward(ctx, g, _g_lse):
    q, k, v, bias, out, lse = ctx.saved_tensors
    dq, dk, dv, db = flash_attn_bwd_op(q, k, v, bias, out, lse, g,
                                       ctx.causal, ctx.scale)
    return dq, dk, dv, (db if ctx.needs_input_grad[3] else None), None, None


flash_attn_op.register_autograd(_flash_attn_backward,
                                setup_context=_flash_attn_setup)


class _FlashAttention(torch.autograd.Function):
    """`flash_attn_op` and its autograd rule for an eager call."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        out, lse = flash_fwd_lse(q, k, v, scale, causal, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, db = _backward(q, k, v, out, lse, g, ctx.scale,
                                   ctx.causal, bias)
        return dq, dk, dv, (db if ctx.needs_input_grad[3] else None), \
            None, None


def _attend(q, k, v, bias, causal, scale):
    """The attention output: eagerly through `_FlashAttention` on plain
    tensors; through the registered op when a Program records (a
    `static.Variable`), `torch.export` traces (fake tensors under a
    dispatch mode) or dynamo compiles."""
    if type(q) is type(k) is type(v) is torch.Tensor \
            and (bias is None or type(bias) is torch.Tensor) \
            and not torch._C._len_torch_dispatch_stack() \
            and not torch.compiler.is_compiling():
        return _FlashAttention.apply(q, k, v, bias, causal, scale)
    return flash_attn_op(q, k, v, bias, causal, scale)[0]


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over q [B, H, Sq, D], k/v
    [B, H, Sk, D]; scale defaults to D**-0.5 (the reference's custom-vjp
    `flash_attention`: K4 forward, K6 + K9 backward, or K6 + K7 + K8 when
    `uses_two_pass` holds). Inputs are made contiguous (the kernels read
    contiguous rows)."""
    return _attend(q.contiguous(), k.contiguous(), v.contiguous(), None,
                   bool(causal), _scale(q, scale))


def flash_attention_bias(q, k, v, bias, causal=False, scale=None):
    """Differentiable flash attention with a per-key additive bias
    [B or 1, Sk] (any float dtype; the kernels read it as float32) over
    q [B, H, Sq, D], k/v [B, H, Sk, D]; scale defaults to D**-0.5 (the
    reference's custom-vjp `flash_attention_bias`: K4 bias forward, K6 +
    K9 bias backward, or K6 + K7 bias + K8 bias). A [1, Sk] bias
    broadcasts over the batch and its gradient is summed over it; the
    gradient reaches the bias through its cast to float32."""
    if bias.dim() != 2 or bias.shape[0] not in (1, q.shape[0]) \
            or bias.shape[1] != k.shape[2]:
        raise ValueError(f"flash_attention_bias: bias {tuple(bias.shape)} "
                         f"is not [{q.shape[0]} or 1, {k.shape[2]}]")
    return _attend(q.contiguous(), k.contiguous(), v.contiguous(),
                   bias.float().contiguous(), bool(causal), _scale(q, scale))


__all__ = ["flash_attention", "flash_attention_bias", "flash_attn_op",
           "flash_attn_bwd_op", "flash_fwd_lse", "flash_delta", "flash_bwd",
           "flash_bwd_two_pass", "uses_two_pass", "flash_fwd_lse_plain",
           "flash_delta_plain", "flash_bwd_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain"]
