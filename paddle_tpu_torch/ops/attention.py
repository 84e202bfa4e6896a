"""Attention ops: the dense op of the training path and the paged ops
of the serving path.

Same signatures and layouts as `paddle_tpu.ops.attention`:

  * `scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
    is_causal=False, scale=None, return_weights=False, generator=None)`
    over q [B, H, Sq, D], k/v [B, H, Sk, D] -> (out, weights or None).
    The route is the reference's and depends on the arguments alone.
    Both flash routes need no dropout, no weights and a head dim the
    kernels take (`kernels.DH_SUPPORTED`: 32, 64, 128):
      - no mask: `flash_attention` (K4 forward, K6 + K9 backward on the
        card, or K6 + K7 + K8 past the reference's length switch,
        `flash_attention.uses_two_pass`);
      - a [B or 1, 1, 1, Sk] additive mask: the mask is a per-key bias
        and goes to `flash_attention_bias` (K4 bias, K6 + K9 bias on the
        card, or K6 + K7 bias + K8 bias);
      - anything else (another mask shape, dropout_p > 0, the weights,
        another head dim — 256 too, which the reference's kernels take
        and the port's do not yet): `dense_attention`, the reference's
        `_xla_attention` in the same order of operations, then the
        attention dropout drawn from `generator` (the reference's
        `key=`).
    On the flash routes q is scaled once and cast back to its dtype and
    the kernels run at scale 1.0, as the reference feeds its kernels;
    autograd carries the scale into dq;

  * `paged_decode_attention(q [B, H, Dh], k_blocks, v_blocks,
    block_tables [B, M], ctx_lens [B])` — one query per sequence over its
    own block table, masked by LENGTH (positions >= ctx_lens[b] never
    count);
  * `ragged_prefill_attention(q [T, H, Dh], k_blocks, v_blocks,
    block_tables [B, M], seg [T], pos [T])` — the segment-causal
    contract of `ops/pallas/unified_attention.py`: row t attends the
    keys of table row seg[t] at cache positions 0..pos[t]; pad rows
    (pos == -1) attend nothing and their output is finite garbage the
    caller discards.

Pools are one layer's `[N, BS, H, Dh]` tensor, or a `QuantizedKV` (int8
codes plus per-vector scales `[N, BS, H]`). Dispatch is by device: a
CUDA query launches the Hopper kernel (`ops.kernels`, which raises on
anything it does not take); a CPU query runs the plain PyTorch version
below. There is no fallback from the kernel to the plain version.

The plain versions are the reference's XLA paths written in torch, in
the same order of operations: one gather per slot ROW (never per
token), heads major, scores cast to float32 after the product, a
softmax in float32 cast back to the compute dtype before the value
product. The kernels instead accumulate every product in float32 and
round the scores not at all (see csrc/unified_attention.cu,
csrc/ragged_stream_sm90.cu and csrc/paged_decode_sm90.cu); K2 keeps the
weights in float32 too, while the bf16 K1 rounds them to bf16 before its
tensor-core value product (as the reference's Pallas kernel does) and
dequantizes int8 vectors to bf16 (the reference's `_load_kv`), so in bf16
the two differ by those roundings. Pad rows of K1 come out as zeros on
the card. A decode row with ctx 0 gives zeros on the card
(as the reference's Pallas kernel does); the plain version, like the
reference's XLA path, averages the row's table there (-1e30 is finite).
"""
from __future__ import annotations

import torch

from . import kernels
from .flash_attention import flash_attention, flash_attention_bias

NEG_INF = -1e30


def is_quantized(kv):
    """Duck-typed QuantizedKV check."""
    return hasattr(kv, "codes") and hasattr(kv, "scales")


def _route(q, *tensors):
    """True -> launch the kernel (q on CUDA); False -> plain (q on the
    CPU). Any other device mix is refused."""
    for t in tensors:
        if t.device.type != q.device.type:
            raise ValueError(f"attention inputs span devices: q on "
                             f"{q.device}, an operand on {t.device}")
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"no attention path for device {q.device}")


def _operands(kv):
    return (kv.codes, kv.scales) if is_quantized(kv) else (kv,)


def _scale(Dh, scale):
    return (Dh ** -0.5) if scale is None else float(scale)


def dense_attention(q, k, v, mask=None, scale=None, causal=False):
    """The reference's `_xla_attention` (`ops/attention.py:41-53`), in its
    order of operations: scores in q's dtype, the causal -1e30 fill
    (bottom-right aligned), then the additive mask, then softmax. Returns
    (out, weights)."""
    sc = _scale(q.shape[-1], scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sc
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool, device=s.device) \
            .tril(sk - sq)
        s = s.masked_fill(~cm, NEG_INF)
    if mask is not None:
        s = s + mask
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v), w


def _key_bias(attn_mask, q, k):
    """The [B or 1, Sk] per-key bias of a [B or 1, 1, 1, Sk] mask, or
    None for any other mask (a [B, 1, 1, 1] keys-broadcast mask is not
    per-key)."""
    m = attn_mask
    if m is None or m.dim() != 4 or m.shape[1] != 1 or m.shape[2] != 1 \
            or m.shape[0] not in (1, q.shape[0]) \
            or m.shape[-1] != k.shape[-2]:
        return None
    return m[:, 0, 0, :]


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None,
                                 return_weights=False, generator=None):
    """Attention over q [B, H, Sq, D], k/v [B, H, Sk, D] (causal:
    bottom-right aligned); the route is chosen from the arguments (see
    the module docstring). Returns (out, weights if return_weights else
    None)."""
    key_bias = _key_bias(attn_mask, q, k)
    if (attn_mask is None or key_bias is not None) and dropout_p == 0.0 \
            and not return_weights and q.shape[-1] in kernels.DH_SUPPORTED:
        sc = _scale(q.shape[-1], scale)
        # prescale q once, rounded to its dtype, as the reference feeds
        # its kernel (ops/attention.py:95-105); the kernels run at scale 1
        qs = (q * sc).to(q.dtype)
        if key_bias is None:
            return flash_attention(qs, k, v, causal=is_causal,
                                   scale=1.0), None
        return flash_attention_bias(qs, k, v, key_bias, causal=is_causal,
                                    scale=1.0), None
    out, w = dense_attention(q, k, v, attn_mask, scale, is_causal)
    if dropout_p > 0.0:
        keep = torch.empty_like(w).bernoulli_(1.0 - dropout_p,
                                              generator=generator)
        w_d = torch.where(keep.bool(), w / (1.0 - dropout_p), 0.0)
        out = torch.einsum("bhqk,bhkd->bhqd", w_d, v)
    return out, (w if return_weights else None)


def paged_decode_attention(q, k_blocks, v_blocks, block_tables, ctx_lens,
                           scale=None):
    """Single-token decode attention over a paged KV cache. Returns
    [B, H, Dh] in q's dtype (see module docstring)."""
    sc = _scale(q.shape[-1], scale)
    if _route(q, *_operands(k_blocks), *_operands(v_blocks), block_tables,
              ctx_lens):
        return kernels.paged_decode(q.contiguous(), k_blocks, v_blocks,
                                    block_tables, ctx_lens, sc)
    return paged_decode_attention_plain(q, k_blocks, v_blocks, block_tables,
                                        ctx_lens, sc)


def paged_decode_attention_plain(q, k_blocks, v_blocks, block_tables,
                                 ctx_lens, scale=None):
    """The plain PyTorch version of K2: gather [B, M*BS] keys per row,
    mask by length, softmax. int8 pools gather codes and fold the
    per-vector scales into the score and probability tensors."""
    quant = is_quantized(k_blocks)
    kcodes = k_blocks.codes if quant else k_blocks
    B, H, Dh = q.shape
    _, BS, _, _ = kcodes.shape
    M = block_tables.shape[1]
    sc = _scale(Dh, scale)
    tb = block_tables.long()
    k = kcodes[tb].permute(0, 3, 1, 2, 4).reshape(B, H, M * BS, Dh)
    vcodes = v_blocks.codes if quant else v_blocks
    v = vcodes[tb].permute(0, 3, 1, 2, 4).reshape(B, H, M * BS, Dh)
    s = torch.einsum("bhd,bhsd->bhs", q, k.to(q.dtype)).float()
    if quant:  # per-KEY scale rides the score tensor post-contraction
        ks = k_blocks.scales[tb].reshape(B, M * BS, H).permute(0, 2, 1)
        s = s * ks.float()
    s = s * sc
    valid = (torch.arange(M * BS, device=q.device)[None, :]
             < ctx_lens[:, None])
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    if quant:
        vs = v_blocks.scales[tb].reshape(B, M * BS, H).permute(0, 2, 1)
        w = w * vs.to(q.dtype)
    return torch.einsum("bhs,bhsd->bhd", w, v.to(q.dtype))


def ragged_prefill_attention(q, k_blocks, v_blocks, block_tables, seg, pos,
                             scale=None):
    """Packed ragged prefill attention over a paged KV cache (the
    segment-causal contract; see module docstring). Returns [T, H, Dh]
    in q's dtype. The kernel takes the per-token seg/pos directly, so
    the packing needs no query-tile alignment."""
    sc = _scale(q.shape[-1], scale)
    if _route(q, *_operands(k_blocks), *_operands(v_blocks), block_tables,
              seg, pos):
        return kernels.ragged_stream(q.contiguous(), k_blocks, v_blocks,
                                     block_tables, seg, pos, sc)
    return ragged_prefill_attention_plain(q, k_blocks, v_blocks,
                                          block_tables, seg, pos, sc)


def ragged_prefill_attention_plain(q, k_blocks, v_blocks, block_tables,
                                   seg, pos, scale=None):
    """The plain PyTorch version of K1: gather ONE [B, M*BS] copy per
    slot row, score every query against every row head-major, and apply
    the row-AND-position mask before a joint softmax over all rows —
    exactly the per-row softmax, because only the query's own row has
    unmasked columns."""
    quant = is_quantized(k_blocks)
    kcodes = k_blocks.codes if quant else k_blocks
    vcodes = v_blocks.codes if quant else v_blocks
    T, H, Dh = q.shape
    _, BS, _, _ = kcodes.shape
    B, M = block_tables.shape
    sc = _scale(Dh, scale)
    tb = block_tables.long()
    k = kcodes[tb].reshape(B, M * BS, H, Dh).permute(2, 0, 1, 3) \
        .to(q.dtype)                                      # [H, B, C, Dh]
    v = vcodes[tb].reshape(B, M * BS, H, Dh).permute(2, 0, 1, 3) \
        .to(q.dtype)
    qh = q.permute(1, 0, 2)                               # [H, T, Dh]
    s = torch.einsum("htd,hbcd->htbc", qh, k).float() * sc
    if quant:  # per-KEY scale rides the score tensor post-contraction
        ks = k_blocks.scales[tb].reshape(B, M * BS, H).permute(2, 0, 1)
        s = s * ks[:, None].float()
    own = seg.long()[:, None] == torch.arange(B, device=q.device)[None, :]
    ok = (torch.arange(M * BS, device=q.device)[None, :]
          <= pos.long()[:, None])                         # [T, M*BS]
    mask = own[:, :, None] & ok[:, None, :]               # [T, B, M*BS]
    s = s.masked_fill(~mask[None], NEG_INF)
    w = torch.softmax(s.reshape(H, T, B * M * BS), dim=-1) \
        .reshape(H, T, B, M * BS).to(q.dtype)
    if quant:  # per-VALUE scale rides the prob tensor
        vs = v_blocks.scales[tb].reshape(B, M * BS, H).permute(2, 0, 1)
        w = w * vs[:, None].to(q.dtype)
    return torch.einsum("htbc,hbcd->htd", w, v).permute(1, 0, 2)


__all__ = ["scaled_dot_product_attention", "dense_attention",
           "paged_decode_attention",
           "paged_decode_attention_plain", "ragged_prefill_attention",
           "ragged_prefill_attention_plain", "is_quantized", "NEG_INF"]
