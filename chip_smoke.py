#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs a CUDA
card and the CUDA toolkit (`nvcc`); it imports nothing of JAX or of the
JAX package. Phases, each printing its own line; any failure exits
non-zero before the result line:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the kernels from paddle_tpu_torch/csrc (the first-use path
               of ops/kernels.py), with the seconds it took;
  3. kernels — K1 (ragged stream) and K2 (paged decode), dense and int8,
               at GPT-2-small shapes (H=12, Dh=64, BS=16; one K2 case at
               BS=128; a tiny H=4, Dh=32, BS=4 case), each against its
               plain PyTorch version on the same inputs, with times:
               the kernel, the plain version, and as `library_ms`
               F.scaled_dot_product_attention on pre-gathered contiguous
               K/V (excluding the gather; the port never calls it);
  4. decoder — GPT-2 small, 12 layers, float32 (TF32 off): one packed
               prefill of a 3-segment stream, 8 steps and one
               multistep(4) on the card (kernels) and on the CPU (plain
               versions, device="cpu") with the same weights; logits
               within atol=2e-3 and identical greedy tokens. The same on
               int8 pools (4b), which is the run the int8 kernels'
               launch counts come from;
  5. serving — GPT-2 small in bfloat16: PagedGenerationServer(max_slots=8,
               block_size=16, max_prompt_len=768, max_new_tokens=32,
               prefill_chunk_tokens=512) serving 16 prompts of 64-768
               tokens, a warm and a measured pass, then again with
               steps_per_dispatch=8. Launch counters are zeroed just
               before each measured pass and read just after: K1 must
               have run >= 12 x prefill dispatches and K2 >= 12 x decode
               steps;
  3b. flash  — K4 (forward with LSE), K6 (delta) and K9 (fused
               backward) against their plain versions on the same inputs,
               bf16 and f32: at the training path's shape (B=16, H=12,
               S=1024, D=64, causal), a ragged one (B=2, H=4, S=1000,
               D=32, causal and not) and, in bf16, B=2 H=8 S=2048 D=128
               causal (the bf16 kernels' two TMA boxes a row and their
               register peak) and B=2 H=4 Sq=384 Sk=256 D=64 causal (dead
               rows through the bf16 K9). In bf16 K4 and K9 are the
               tensor-core kernels of csrc/flash_fwd_sm90.cu and
               csrc/flash_bwd_sm90.cu. K9's dk and dv must be bitwise
               equal over two launches. Errors are relative to the plain
               output's largest magnitude: 2e-2 for out/dq/dk/dv in bf16,
               1e-4 for everything else. Times at the main shape in bf16:
               the kernel, the plain version, and as `library_ms` one
               PyTorch call for the same function (K4: the forward of
               F.scaled_dot_product_attention; K9: its backward through
               torch.autograd.grad; K6: torch.linalg.vecdot) — none of
               them on the port's path. For K4 and K9 also the achieved
               TFLOP/s, the share of the bound and the ratio to the
               library time (the same for K4 bias and K9 bias in 3c);
  4c. train parity — GPT-2 small, 12 layers, float32 (TF32 off), batch
               2 x 256, dropout 0: two AdamW steps (lr 1e-4, wd 0.01) on
               the card (kernels) and on the CPU (plain versions) from the
               same weights; loss within 1e-4 relative at each step, each
               gradient within 1e-3 of its largest magnitude, parameters
               within 2 * lr * steps + 1e-6 after two steps; K4, K6 and K9
               must each launch exactly 12 times per step on the card;
  6. training — GPT-2 small, bf16 compute on float32 masters (the
               reference bench's mixed-precision step), batch 16 x 1024,
               AdamW: 2 warm and 5 measured steps on one fixed batch;
               tokens/s, ms per step (CUDA events), peak memory, first and
               last loss. Fails on a non-finite loss, a last loss not
               below the first, or K4/K6/K9 launching other than
               12 x steps times in the measured steps;
  3c. bias flash — K4 bias (forward with a per-key bias) and K9 bias
               (fused backward with dbias), with K6 between them, against
               their plain versions, bf16 and f32: at BERT-large's
               attention shape (B=16, H=16, S=512, D=64, not causal) with
               a per-row padding mask from lengths in 128-512; a ragged
               causal one (B=2, H=4, S=300, D=32); Sq != Sk (256 x 384);
               a [1, Sk] bias broadcast over the batch; and a batch row
               that is fully masked (not causal and causal). out, lse, dq,
               dk, dv and dbias within phase 3b's tolerances; K9 bias's dk,
               dv and dbias bitwise equal over two launches. Times at the
               main shape in bf16: the kernel, the plain version, and as
               `library_ms` F.scaled_dot_product_attention with attn_mask
               = bias[:, None, None, :] (its forward; its backward through
               torch.autograd.grad);
  4d. BERT train parity — BERT-large width and depth, float32 (TF32 off),
               batch 2 x 128 padded to lengths 128 and 77, MLM labels from
               the port's create_mlm_batch plus NSP labels: two AdamW steps
               through pretraining_loss(..., attention_mask=...) on the card
               and on the CPU from the same weights, with phase 4c's limits
               (a gradient whose exact value is zero — the k_proj biases —
               is held to 1e-3 of the step's largest gradient); K4 bias, K6
               and K9 bias launch exactly num_layers times per step on the
               card, the unbiased K4/K9 never;
  6b. BERT training — BERT-large, bf16 compute on float32 masters,
               AdamW (lr 1e-4, wd 0.01), dropout 0, batch 16 x 512 padded
               with lengths from np.random.RandomState(0) in 128-512 (pad
               id 0; token types 0 for the first half of each sequence, 1
               after; MLM labels from create_mlm_batch(mask_prob=0.15);
               random NSP labels): 2 warm and 13 measured steps (at this
               constant lr without warmup, post-LN BERT-large's loss spikes
               at step 2 and falls below its start only from step 9 on —
               in the kernels, the plain attention and float32 alike);
               tokens/s (padded tokens, as bench.py counts them), ms per
               step (CUDA events), peak memory, first and last loss. Fails
               on a non-finite loss, a last loss not below the first, or
               K4 bias/K6/K9 bias launching other than 24 x steps times;
  3d. two-pass flash — K7 (dq) and K8 (dk, dv) and their bias variants
               K7 bias / K8 bias (dbias too), with K4 (bias) and K6 before
               them, against their plain versions on the same inputs, bf16
               and f32, within phase 3b's tolerances: (a) the training
               shape (B=16, H=12, S=1024, D=64, causal), also against K9
               (bias) on the same inputs; (b) B=1, H=2, S=16384, D=64,
               causal, bf16 (the plain version at H=2: its [S, S] float32
               tensors take 2.1 GB each); (c) ragged B=2, H=4, S=1000,
               D=32, causal and not; (d) Sq != Sk, 256 x 384, not causal;
               (e) an LSE and delta of attention over [k0; k1] with the
               kernels run on k1 alone (a ring block); (f) phase 3c's bias
               cases, and phase 6c's padded batch at H=2 (B=2, S=16384,
               D=64, causal, bf16, lengths 16384 and 10240, the per-row
               bias at its long batch stride; the plain version peaks near
               26 GB). In every case two launches must give the same bits
               (g: no atomics). Times at (a) and at 3c's main shape in
               bf16: the kernel, the plain version, and as `library_ms`
               the backward of F.scaled_dot_product_attention through
               torch.autograd.grad (K9's yardstick, for the pair);
  4e. long-context parity — GPT-2 layout with 2 layers, hidden 128, 2
               heads (D 64), vocab 1024, max_position 13312 (13 x 1024,
               past the reference's switch to the two-pass backward at
               S 13108 for D 64), float32 (TF32 off): two AdamW steps on
               the card and on the CPU from the same weights at 1 x 13312
               unpadded, then padded to 9000 tokens (an additive
               [1, 1, 1, S] mask through logits(..., attn_mask=) and
               cross_entropy, pad labels -100), with phase 4c's limits;
               per step on the card K7 and K8 (their bias variants when
               padded) launch num_layers times each and K9 (bias) never;
  6c. long-context training — GPT-2 small at full width with
               max_position 16384, dropout 0, bf16 on float32 masters,
               AdamW (lr 1e-4, wd 0.01): 1 x 16384 unpadded (1 warm and 3
               measured steps) and 2 x 16384 padded to lengths 16384 and
               10240 (1 warm and 2 measured); tokens/s (padded tokens
               counted), ms per step (CUDA events), peak memory, losses.
               Fails on a non-finite loss, K7/K8 (bias) launching other
               than 12 x steps times, or K9/K9 bias launching at all;
  7. the kernels line (JSON; each kernel's launches summed over the
     main-path runs that reach it: phases 5, 4b, 6, 6b and 6c), the card
     line, and as the last line {"ok": true, "device": {...}}.

Bounds (`bound_ms`): the larger of the bytes the function must move (each
input read once, each output written once; only the K/V positions this
run's lengths reach) over 3.35 TB/s and its FLOPs over 989 TFLOP/s (the
H100 SXM bf16 dense peak, applied to the float32 SIMT kernels too), from
this run's inputs. Flash FLOPs count only the (query, key) pairs the
causal mask leaves visible; the bias variants count every pair (the bias
is data, not structure). Per pair K4 does 4 * D FLOPs, K9 10 * D, K7
6 * D (s, dp, dq) and K8 8 * D (s, dp, dv, dk).
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
REPO = os.path.dirname(os.path.abspath(__file__))
K1_REPLACES = "paddle_tpu/ops/pallas/unified_attention.py:206"
K2_REPLACES = "paddle_tpu/ops/pallas/unified_attention.py:327"
FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:228",
    "flash_delta": "paddle_tpu/ops/pallas/flash_attention.py:483",
    "flash_bwd": "paddle_tpu/ops/pallas/flash_attention.py:504",
    "flash_fwd_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:228 (has_bias)",
    "flash_bwd_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:504 (has_bias)",
    "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:580",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:615",
    "flash_bwd_dq_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:580 (has_bias)",
    "flash_bwd_dkv_bias":
        "paddle_tpu/ops/pallas/flash_attention.py:615 (has_bias)"}
SOURCE = "paddle_tpu_torch/csrc/unified_attention.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FWD_SOURCE = "paddle_tpu_torch/csrc/flash_fwd_sm90.cu"  # K4 (bias) in bf16
BWD_SOURCE = "paddle_tpu_torch/csrc/flash_bwd_sm90.cu"  # K9 (bias) in bf16
TWO_PASS_SOURCE = "paddle_tpu_torch/csrc/flash_bwd_two_pass.cu"
FLASH = ("flash_fwd", "flash_delta", "flash_bwd")
FLASH_BIAS = ("flash_fwd_bias", "flash_delta", "flash_bwd_bias")
TWO_PASS = ("flash_fwd", "flash_delta", "flash_bwd_dq", "flash_bwd_dkv")
TWO_PASS_BIAS = ("flash_fwd_bias", "flash_delta", "flash_bwd_dq_bias",
                 "flash_bwd_dkv_bias")
FUSED_BWD = ("flash_bwd", "flash_bwd_bias")
DEV = "cuda"  # the card every phase runs on (the CPU is the other side
# of the phase 4 comparison)


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    say(f"FAIL {msg}")
    sys.exit(1)


# ---- timing ----------------------------------------------------------------

class Timer:
    """Median of per-launch CUDA-event times, with the 50 MB L2 flushed
    (a 64 MiB write) before every launch: on the serving path each layer's
    launch reads another layer's pool, cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, reps=25, warm=2):
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


# ---- phase 3: kernel cases --------------------------------------------------

def _tables(torch, lens, bs, idle_first, seed):
    """Disjoint random pool blocks per row, 0-padded; row 0 all-trash
    when idle_first (an idle decode slot: ctx 1 on block 0)."""
    rs = np.random.RandomState(seed)
    nb = [-(-int(c) // bs) for c in lens]
    m = max(nb)
    perm = rs.permutation(sum(nb) + 8) + 1
    tab = np.zeros((len(lens), m), np.int32)
    o = 0
    for b, k in enumerate(nb):
        if idle_first and b == 0:
            continue
        tab[b, :k] = perm[o:o + k]
        o += k
    return torch.from_numpy(tab).to(DEV), int(perm.max()) + 1


def _pools(torch, n, bs, h, dh, quant, g):
    from paddle_tpu_torch.inference.kv_quant import QuantizedKV, kv_encode

    k = torch.randn(n, bs, h, dh, generator=g, device=DEV)
    v = torch.randn(n, bs, h, dh, generator=g, device=DEV)
    if quant:
        return (QuantizedKV(*kv_encode(k, torch.bfloat16)),
                QuantizedKV(*kv_encode(v, torch.bfloat16)))
    return k.bfloat16(), v.bfloat16()


def _dequant(kv, dtype):
    if hasattr(kv, "codes"):
        return kv.codes.to(dtype) * kv.scales[..., None].to(dtype)
    return kv.to(dtype)


def _f32(kv):
    if hasattr(kv, "codes"):
        return type(kv)(kv.codes, kv.scales.float())
    return kv.float()


def _elem(kv):
    """Bytes per pool vector element, and per-vector scale bytes."""
    if hasattr(kv, "codes"):
        return 1, kv.scales.element_size()
    return kv.element_size(), 0


def decode_case(torch, timer, h, dh, bs, quant, seed, timed):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import paged_decode_attention_plain

    lens = [1, 1024, 512, 777, 33, 1000, 300, 129]
    if bs == 4:
        lens = [1, 37, 16, 64]
    g = torch.Generator(device=DEV).manual_seed(seed)
    tables, n = _tables(torch, lens, bs, True, seed)
    kb, vb = _pools(torch, n, bs, h, dh, quant, g)
    B = len(lens)
    q = torch.randn(B, h, dh, generator=g, device=DEV).bfloat16()
    ctx = torch.tensor(lens, dtype=torch.int32, device=DEV)
    sc = dh ** -0.5
    out = kernels.paged_decode(q, kb, vb, tables, ctx, sc)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q.float(), _f32(kb), _f32(vb),
                                       tables, ctx, sc)
    err = (out.float() - ref).abs().max().item()
    ok = torch.isfinite(out).all().item() and torch.allclose(
        out.float(), ref, atol=2e-2, rtol=2e-2)
    res = {"max_abs_err": err, "ok": bool(ok)}
    if not timed:
        return res
    res["ms"] = timer.ms(lambda: kernels.paged_decode(q, kb, vb, tables,
                                                      ctx, sc))
    res["plain_ms"] = timer.ms(lambda: paged_decode_attention_plain(
        q, kb, vb, tables, ctx, sc))
    # library: SDPA over pre-gathered contiguous K/V (gather excluded)
    cmax = max(lens)
    gk = _dequant(kb, torch.bfloat16)[tables.long()].reshape(
        B, -1, h, dh)[:, :cmax].permute(0, 2, 1, 3).contiguous()
    gv = _dequant(vb, torch.bfloat16)[tables.long()].reshape(
        B, -1, h, dh)[:, :cmax].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(cmax, device=DEV)[None, :]
            < ctx[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, gk, gv, attn_mask=mask, scale=sc))
    e, s = _elem(kb)
    tot = sum(lens)
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + 2 * tot * h * (dh * e + s)             # live K and V
              + sum(-(-c // bs) for c in lens) * 4 + B * 4)
    flops = 4 * h * dh * tot
    res.update(_bound(nbytes, flops))
    return res


def stream_case(torch, timer, h, dh, bs, quant, seed, timed):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import ragged_prefill_attention_plain

    if bs == 4:   # tiny: prefix chunk, fresh segment, pads
        segs, pads = [(0, 10, 16), (1, 0, 13)], 5
    else:         # ~512 tokens: cached-prefix chunk, fresh segment,
        # a partial segment with pads, a pad region
        segs, pads = [(0, 300, 128), (1, 0, 200), (2, 0, 101)], 80
    g = torch.Generator(device=DEV).manual_seed(seed)
    tables, n = _tables(torch, [s0 + m for _r, s0, m in segs], bs, False,
                        seed)
    seg, pos = [], []
    for r, s0, m in segs:
        fill = -(-m // 8) * 8
        seg += [r] * fill
        pos += list(range(s0, s0 + m)) + [-1] * (fill - m)
    seg += [0] * pads
    pos += [-1] * pads
    T = len(seg)
    seg_t = torch.tensor(seg, dtype=torch.int32, device=DEV)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    kb, vb = _pools(torch, n, bs, h, dh, quant, g)
    q = torch.randn(T, h, dh, generator=g, device=DEV).bfloat16()
    sc = dh ** -0.5
    out = kernels.ragged_stream(q, kb, vb, tables, seg_t, pos_t, sc)
    torch.cuda.synchronize()
    ref = ragged_prefill_attention_plain(q.float(), _f32(kb), _f32(vb),
                                         tables, seg_t, pos_t, sc)
    valid = pos_t >= 0
    err = (out[valid].float() - ref[valid]).abs().max().item()
    ok = torch.isfinite(out).all().item() and torch.allclose(
        out[valid].float(), ref[valid], atol=2e-2, rtol=2e-2)
    res = {"max_abs_err": err, "ok": bool(ok), "tokens": T}
    if not timed:
        return res
    res["ms"] = timer.ms(lambda: kernels.ragged_stream(
        q, kb, vb, tables, seg_t, pos_t, sc))
    res["plain_ms"] = timer.ms(lambda: ragged_prefill_attention_plain(
        q, kb, vb, tables, seg_t, pos_t, sc), reps=10)
    # library: one SDPA call over every segment's pre-gathered keys, the
    # segment-causal mask spelled out (gather excluded)
    kd, vd = _dequant(kb, torch.bfloat16), _dequant(vb, torch.bfloat16)
    cols_k, cols_v, col_seg, col_pos = [], [], [], []
    for r, s0, m in segs:
        c = s0 + m
        rows = tables[r].long()
        cols_k.append(kd[rows].reshape(-1, h, dh)[:c])
        cols_v.append(vd[rows].reshape(-1, h, dh)[:c])
        col_seg += [r] * c
        col_pos += list(range(c))
    gk = torch.cat(cols_k).permute(1, 0, 2)[None].contiguous()
    gv = torch.cat(cols_v).permute(1, 0, 2)[None].contiguous()
    cs = torch.tensor(col_seg, device=DEV)
    cp = torch.tensor(col_pos, device=DEV)
    mask = (seg_t.long()[:, None] == cs[None]) & \
        (cp[None] <= pos_t.long()[:, None])
    mask[~valid, 0] = True  # pad rows: one key, no NaN row
    q4 = q.permute(1, 0, 2)[None]
    res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, gk, gv, attn_mask=mask[None, None], scale=sc))
    e, s = _elem(kb)
    keys = sum(s0 + m for _r, s0, m in segs)  # each segment's horizon
    nbytes = (2 * q.numel() * q.element_size() + 2 * T * 4
              + 2 * keys * h * (dh * e + s)
              + sum(-(-(s0 + m) // bs) for _r, s0, m in segs) * 4)
    flops = 4 * h * dh * sum(p + 1 for p in pos if p >= 0)
    res.update(_bound(nbytes, flops))
    return res


def _bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "bytes": int(nbytes), "flops": int(flops)}


# ---- phase 3b: flash kernels ----------------------------------------------

def _pairs(sq, sk, causal):
    """(query, key) pairs the mask leaves visible (bottom-right causal)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def _rates(phase, name, tag, r):
    """A kernel's achieved TFLOP/s, share of its bound and ratio to the
    library call, from a timed row."""
    say(f"phase {phase} {name} {tag}: {r['flops'] / r['ms'] / 1e9:.1f} "
        f"TFLOP/s achieved, {r['bound_ms'] / r['ms']:.3f} of the bound "
        f"({r['bound_by']}), {r['ms'] / r['library_ms']:.2f}x the "
        f"library's time")


def _rel_err(out, ref):
    """(max abs error, that error over the plain output's max abs)."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def flash_case(torch, timer, b, h, sq, sk, d, causal, dtype, seed, timed):
    """K4, K6 and K9 against their plain versions (computed in float32
    from the same inputs), and K9's dk and dv bitwise equal over two
    launches; with `timed`, the kernel, plain and library times and the
    bounds. Returns {kernel name: row} or fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device=DEV)
                   .to(dtype) for n in (sq, sk, sk, sq))
    sc = d ** -0.5
    out, lse = kernels.flash_fwd(q, k, v, sc, causal)
    delta = kernels.flash_delta(out, do)
    grads = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
    again = kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = pf.flash_fwd_lse_plain(f[0], f[1], f[2], sc, causal)
    delta_p = pf.flash_delta_plain(out.float(), f[3])
    grads_p = pf.flash_bwd_plain(f[0], f[1], f[2], f[3], lse, delta, sc,
                                 causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    checks = {"out": (out, out_p, tol), "lse": (lse, lse_p, 1e-4),
              "delta": (delta, delta_p, 1e-4)}
    for name, a, p in zip(("dq", "dk", "dv"), grads, grads_p):
        checks[name] = (a, p, tol)
    errs = {}
    tag = (f"B{b} H{h} {f'S{sq}' if sq == sk else f'Sq{sq} Sk{sk}'} D{d} "
           f"{'causal' if causal else 'full'} {str(dtype).split('.')[-1]}")
    for name, a, a2 in zip(("dk", "dv"), grads[1:], again[1:]):
        if not torch.equal(a, a2):
            fail(f"phase 3b {tag}: {name} differs between two launches")
    del again
    for name, (a, p, t) in checks.items():
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > t:
            fail(f"phase 3b {tag}: {name} disagrees with plain (max abs "
                 f"err {err:.3g}, {rel:.3g} of its magnitude > {t})")
    rows = {"flash_fwd": {"max_abs_err": max(errs["out"], errs["lse"])},
            "flash_delta": {"max_abs_err": errs["delta"]},
            "flash_bwd": {"max_abs_err": max(errs["dq"], errs["dk"],
                                             errs["dv"])}}
    say(f"phase 3b {tag}: max abs err out {errs['out']:.3g} lse "
        f"{errs['lse']:.3g} delta {errs['delta']:.3g} dq {errs['dq']:.3g} "
        f"dk {errs['dk']:.3g} dv {errs['dv']:.3g}; dk, dv bitwise repeatable")
    if not timed:
        return rows
    del out_p, lse_p, delta_p, grads_p, f
    fw, dl, bw = rows["flash_fwd"], rows["flash_delta"], rows["flash_bwd"]
    fw["ms"] = timer.ms(lambda: kernels.flash_fwd(q, k, v, sc, causal))
    fw["plain_ms"] = timer.ms(lambda: pf.flash_fwd_lse_plain(
        q, k, v, sc, causal), reps=10)
    fw["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=sc))
    dl["ms"] = timer.ms(lambda: kernels.flash_delta(out, do))
    dl["plain_ms"] = timer.ms(lambda: pf.flash_delta_plain(out, do))
    dl["library_ms"] = timer.ms(lambda: torch.linalg.vecdot(out, do))
    bw["ms"] = timer.ms(lambda: kernels.flash_bwd(q, k, v, do, lse, delta,
                                                  sc, causal))
    bw["plain_ms"] = timer.ms(lambda: pf.flash_bwd_plain(
        q, k, v, do, lse, delta, sc, causal), reps=10)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                        scale=sc)
    bw["library_ms"] = timer.ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    e, bh, pairs = q.element_size(), b * h, _pairs(sq, sk, causal)
    qv = bh * sq * d * e  # bytes of q (and out, do, dq)
    kv = bh * sk * d * e  # bytes of k (and v, dk, dv)
    fw.update(_bound(2 * qv + 2 * kv + 4 * bh * sq, 4 * bh * d * pairs))
    dl.update(_bound(2 * qv + 4 * bh * sq, 2 * bh * sq * d))
    bw.update(_bound(3 * qv + 4 * kv + 8 * bh * sq, 10 * bh * d * pairs))
    for name, r in rows.items():
        say(f"phase 3b {name} {tag}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    _rates("3b", "flash_fwd", tag, fw)
    _rates("3b", "flash_bwd", tag, bw)
    return rows


# ---- phase 3c: per-key-bias flash kernels -------------------------------------

def _key_bias(torch, kind, b, sk, seed, lo, lengths=None):
    """float32 per-key bias: padding masks (0 / -1e30) from lengths in
    [lo, sk] or the `lengths` given ("lengths"), the same with batch row 0
    fully masked ("dead_row"), or one random row broadcast over the batch
    ("broadcast")."""
    rs = np.random.RandomState(seed)
    if kind == "broadcast":
        return torch.from_numpy(rs.randn(1, sk).astype(np.float32)).to(DEV)
    lens = (np.asarray(lengths) if lengths is not None
            else rs.randint(lo, sk + 1, b))
    if kind == "dead_row":
        lens[0] = 0
    bias = np.where(np.arange(sk)[None] < lens[:, None], 0.0, -1e30)
    return torch.from_numpy(bias.astype(np.float32)).to(DEV)


def bias_flash_case(torch, timer, b, h, sq, sk, d, causal, kind, dtype,
                    seed, timed):
    """K4 bias, K6 and K9 bias against their plain versions (float32,
    from the same inputs), and K9 bias's dk, dv and dbias bitwise equal
    over two launches; with `timed`, the kernel, plain and library times
    and the bounds. Returns {kernel name: row} or fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g, device=DEV).to(dtype)
            for _ in range(2))
    # the main shape's lengths are BERT's padded batch (128-512)
    bias = _key_bias(torch, kind, b, sk, seed, 128 if sk == 512 else sk // 4)
    sc = d ** -0.5
    out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    delta = kernels.flash_delta(out, do)
    grads = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc, causal)
    again = kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc, causal)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    out_p, lse_p = pf.flash_fwd_lse_plain(f[0], f[1], f[2], sc, causal,
                                          bias)
    grads_p = pf.flash_bwd_plain(f[0], f[1], f[2], f[3], lse, delta, sc,
                                 causal, bias)
    tag = (f"B{b} H{h} Sq{sq} Sk{sk} D{d} {'causal' if causal else 'full'} "
           f"{kind} {str(dtype).split('.')[-1]}")
    for name, a, a2 in zip(("dk", "dv", "dbias"), grads[1:], again[1:]):
        if not torch.equal(a, a2):
            fail(f"phase 3c {tag}: {name} differs between two launches")
    del again
    live = lse_p > -1e29  # a fully masked row's lse is the -1e30 fill
    if not (lse[~live] <= -1e29).all().item():
        fail(f"phase 3c {tag}: a fully masked row's lse is not the fill")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    checks = {"out": (out, out_p, tol), "lse": (lse[live], lse_p[live], 1e-4)}
    for name, a, p in zip(("dq", "dk", "dv", "dbias"), grads, grads_p):
        checks[name] = (a, p, tol)
    errs = {}
    for name, (a, p, t) in checks.items():
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > t:
            fail(f"phase 3c {tag}: {name} disagrees with plain (max abs "
                 f"err {err:.3g}, {rel:.3g} of its magnitude > {t})")
    say(f"phase 3c {tag}: max abs err " + " ".join(
        f"{n} {e:.3g}" for n, e in errs.items())
        + "; dk, dv, dbias bitwise repeatable")
    rows = {"flash_fwd_bias": {"max_abs_err": max(errs["out"], errs["lse"])},
            "flash_bwd_bias": {"max_abs_err": max(
                errs["dq"], errs["dk"], errs["dv"], errs["dbias"])}}
    if not timed:
        return rows
    del out_p, lse_p, grads_p, f
    fw, bw = rows["flash_fwd_bias"], rows["flash_bwd_bias"]
    fw["ms"] = timer.ms(lambda: kernels.flash_fwd_bias(q, k, v, bias, sc,
                                                       causal))
    fw["plain_ms"] = timer.ms(lambda: pf.flash_fwd_lse_plain(
        q, k, v, sc, causal, bias), reps=10)
    mask = bias.to(dtype)[:, None, None, :]
    fw["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, scale=sc))
    bw["ms"] = timer.ms(lambda: kernels.flash_bwd_bias(
        q, k, v, do, lse, delta, bias, sc, causal))
    bw["plain_ms"] = timer.ms(lambda: pf.flash_bwd_plain(
        q, k, v, do, lse, delta, sc, causal, bias), reps=10)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal, scale=sc)
    bw["library_ms"] = timer.ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    # every (query, key) pair counts: the bias is data, not structure
    e, bh, pairs = q.element_size(), b * h, sq * sk
    qv = bh * sq * d * e   # bytes of q (and out, do, dq)
    kv = bh * sk * d * e   # bytes of k (and v, dk, dv)
    nb = bias.numel() * 4
    fw.update(_bound(2 * qv + 2 * kv + 4 * bh * sq + nb,
                     4 * bh * d * pairs))
    bw.update(_bound(3 * qv + 4 * kv + 8 * bh * sq + nb + 4 * bh * sk,
                     10 * bh * d * pairs))
    for name, r in rows.items():
        say(f"phase 3c {name} {tag}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    _rates("3c", "flash_fwd_bias", tag, fw)
    _rates("3c", "flash_bwd_bias", tag, bw)
    return rows


# ---- phase 3d: the two-pass backward -----------------------------------------

def _two_pass_launch(kernels, q, k, v, do, lse, delta, bias, sc, causal):
    """(dq, dk, dv, dbias or None) from K7 and K8 (bias variants with a
    bias)."""
    if bias is None:
        dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, sc, causal)
        return (dq,) + kernels.flash_bwd_dkv(q, k, v, do, lse, delta, sc,
                                             causal) + (None,)
    dq = kernels.flash_bwd_dq_bias(q, k, v, do, lse, delta, bias, sc, causal)
    return (dq,) + kernels.flash_bwd_dkv_bias(q, k, v, do, lse, delta, bias,
                                              sc, causal)


def two_pass_case(torch, timer, b, h, sq, sk, d, causal, kind, dtype, seed,
                  timed, external=False, lengths=None):
    """K7 and K8 (K7 bias and K8 bias with a bias of `kind`, from
    `lengths` when given) against their plain versions, on K4 (bias)'s lse
    and K6's delta; two launches must agree bit for bit. external: the lse
    and delta are those of attention over [k0; k1] and the kernels run on
    k1 alone. With `timed`, also
    K9 (bias) on the same inputs, the times and the bounds. Returns
    {kernel name: row} or fails."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as pf
    from paddle_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    nk = 2 * sk if external else sk
    q, do = (torch.randn(b, h, sq, d, generator=g, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, nk, d, generator=g, device=DEV).to(dtype)
            for _ in range(2))
    bias = None
    if kind is not None:
        bias = _key_bias(torch, kind, b, sk, seed, 128 if sk == 512
                         else sk // 4, lengths)
    sc = d ** -0.5
    if bias is None:
        out, lse = kernels.flash_fwd(q, k, v, sc, causal)
    else:
        out, lse = kernels.flash_fwd_bias(q, k, v, bias, sc, causal)
    delta = kernels.flash_delta(out, do)
    if external:  # the second block of keys, under the global lse
        k, v = (t[:, :, sk:].contiguous() for t in (k, v))
    grads = _two_pass_launch(kernels, q, k, v, do, lse, delta, bias, sc,
                             causal)
    again = _two_pass_launch(kernels, q, k, v, do, lse, delta, bias, sc,
                             causal)
    torch.cuda.synchronize()
    tag = (f"B{b} H{h} Sq{sq} Sk{sk} D{d} {'causal' if causal else 'full'}"
           f"{' ' + kind if kind else ''}"
           f"{' ' + '/'.join(map(str, lengths)) if lengths else ''}"
           f"{' external-lse' if external else ''}"
           f" {str(dtype).split('.')[-1]}")
    for name, a, a2 in zip(("dq", "dk", "dv", "dbias"), grads, again):
        if a is not None and not torch.equal(a, a2):
            fail(f"phase 3d {tag}: {name} differs between two launches")
    f = [t.float() for t in (q, k, v, do)]
    plain = (pf.flash_bwd_dq_plain(*f, lse, delta, sc, causal, bias),) + \
        pf.flash_bwd_dkv_plain(*f, lse, delta, sc, causal, bias)
    del f
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs = {}
    for name, a, p in zip(("dq", "dk", "dv", "dbias"), grads, plain):
        if a is None:
            continue
        err, rel = _rel_err(a, p)
        errs[name] = err
        if not torch.isfinite(a).all().item() or rel > tol:
            fail(f"phase 3d {tag}: {name} disagrees with plain (max abs "
                 f"err {err:.3g}, {rel:.3g} of its magnitude > {tol})")
    del plain
    fused = None
    if timed:  # K9 (bias) on the same inputs
        fused = (kernels.flash_bwd(q, k, v, do, lse, delta, sc, causal)
                 if bias is None else
                 kernels.flash_bwd_bias(q, k, v, do, lse, delta, bias, sc,
                                        causal))
        for name, a, p in zip(("dq", "dk", "dv", "dbias"), grads, fused):
            if a is None:
                continue
            err, rel = _rel_err(a, p)
            if rel > tol:
                fail(f"phase 3d {tag}: {name} disagrees with K9 (max abs "
                     f"err {err:.3g}, {rel:.3g} of its magnitude > {tol})")
    say(f"phase 3d {tag}: max abs err vs plain " + " ".join(
        f"{n} {e:.3g}" for n, e in errs.items()) + ", bitwise repeatable"
        + (", within tolerance of K9" if timed else ""))
    suffix = "" if bias is None else "_bias"
    dq_row = {"max_abs_err": errs["dq"]}
    dkv_row = {"max_abs_err": max(v_ for n, v_ in errs.items() if n != "dq")}
    rows = {"flash_bwd_dq" + suffix: dq_row,
            "flash_bwd_dkv" + suffix: dkv_row}
    if not timed:
        return rows
    del fused
    args = (q, k, v, do, lse, delta)
    if bias is None:
        dq_ms = timer.ms(lambda: kernels.flash_bwd_dq(*args, sc, causal))
        dkv_ms = timer.ms(lambda: kernels.flash_bwd_dkv(*args, sc, causal))
        k9_ms = timer.ms(lambda: kernels.flash_bwd(*args, sc, causal))
        mask = None
    else:
        dq_ms = timer.ms(lambda: kernels.flash_bwd_dq_bias(*args, bias, sc,
                                                           causal))
        dkv_ms = timer.ms(lambda: kernels.flash_bwd_dkv_bias(*args, bias, sc,
                                                             causal))
        k9_ms = timer.ms(lambda: kernels.flash_bwd_bias(*args, bias, sc,
                                                        causal))
        mask = bias.to(dtype)[:, None, None, :]
    dq_row["ms"], dkv_row["ms"] = dq_ms, dkv_ms
    dq_row["plain_ms"] = timer.ms(lambda: pf.flash_bwd_dq_plain(
        *args, sc, causal, bias), reps=10)
    dkv_row["plain_ms"] = timer.ms(lambda: pf.flash_bwd_dkv_plain(
        *args, sc, causal, bias), reps=10)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal, scale=sc)
    lib = timer.ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), do,
                                               retain_graph=True))
    dq_row["library_ms"] = dkv_row["library_ms"] = lib
    e, bh = q.element_size(), b * h
    pairs = _pairs(sq, sk, causal)
    qv, kv = bh * sq * d * e, bh * sk * d * e  # bytes of q (dO, dq); k (v)
    vec = 8 * bh * sq                           # lse and delta
    nb = 0 if bias is None else bias.numel() * 4
    dq_row.update(_bound(3 * qv + 2 * kv + vec + nb, 6 * bh * d * pairs))
    dkv_row.update(_bound(2 * qv + 4 * kv + vec + nb
                          + (0 if bias is None else 4 * bh * sk),
                          8 * bh * d * pairs))
    for name, r in rows.items():
        say(f"phase 3d {name} {tag}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    say(f"phase 3d {tag}: K7 + K8 {dq_ms + dkv_ms:.4f} ms, K9"
        f"{'' if bias is None else ' bias'} {k9_ms:.4f} ms on the same "
        f"inputs (ratio {(dq_ms + dkv_ms) / k9_ms:.2f})")
    return rows


# ---- phases 4c and 6: training ---------------------------------------------

def _batch(torch, cfg, b, s, seed, dev, lengths=None):
    """Random ids and labels [b, s]; with lengths, a padded batch: labels
    -100 and an additive [b, 1, 1, s] float32 mask of -1e30 past each
    row's length."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels}
    if lengths is not None:
        pad = np.arange(s)[None] >= np.asarray(lengths)[:, None]
        labels[pad] = -100
        batch["attn_mask"] = np.where(pad, -1e30, 0.0).astype(
            np.float32)[:, None, None, :]
    return {n: torch.from_numpy(a).to(dev) for n, a in batch.items()}


def lm_batch_loss(cfg, loss_fn):
    """loss(params, batch): build_train_step's loss_fn for an unpadded
    batch; for a padded one (an "attn_mask"), logits(..., attn_mask=) and
    cross_entropy over the non-pad labels (the reference's GPT2.forward
    takes the mask; its loss and train step do not)."""
    from paddle_tpu_torch.models.gpt2 import logits
    from paddle_tpu_torch.ops.loss import cross_entropy

    def loss(params, batch):
        if "attn_mask" not in batch:
            return loss_fn(params, batch)
        lg = logits(params, cfg, batch["input_ids"],
                    attn_mask=batch["attn_mask"])
        return cross_entropy(lg.reshape(-1, cfg.vocab_size),
                             batch["labels"].reshape(-1))

    return loss


def amp_train_step(torch, cfg, batch, lr=1e-4):
    """The reference bench's mixed-precision step (bench.py:179-188) on
    the card: float32 masters, bf16 copies made inside the autograd
    graph, the loss cast to float32, gradients landing on the masters,
    AdamW (wd 0.01) in float32. Returns step() -> the loss tensor."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    loss_fn, init_params = build_train_step(cfg, device=DEV)
    loss_fn = lm_batch_loss(cfg, loss_fn)
    masters = init_params()
    opt = AdamW(lr, weight_decay=0.01, device=DEV)
    state = opt.functional_init(masters)

    def step():
        low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
        loss = loss_fn(low, batch).float()
        grads = torch.autograd.grad(loss, list(masters.values()))
        opt.functional_update(masters, dict(zip(masters, grads)), state)
        return loss.detach()

    return step


def train_parity(torch, cfg, lr=1e-4, steps=2, b=2, s=256, lengths=None,
                 expect=FLASH, never=(), phase="4c"):
    """Phases 4c and 4e: float32 AdamW steps on the card and on the CPU
    from the same weights, on a [b, s] batch (padded to `lengths` with a
    mask); per step on the card each kernel of `expect` launches
    num_layers times and none of `never` launches. Returns the worst
    (loss, gradient, parameter) differences."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    loss_fn, init_params = build_train_step(cfg, device=DEV)
    loss_fn = lm_batch_loss(cfg, loss_fn)
    params = {DEV: init_params()}
    params["cpu"] = {n: p.detach().cpu().requires_grad_(True)
                     for n, p in params[DEV].items()}
    opts = {d: AdamW(lr, weight_decay=0.01, device=d) for d in params}
    states = {d: opts[d].functional_init(params[d]) for d in params}
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        out = {}
        for d in (DEV, "cpu"):
            batch = _batch(torch, cfg, b, s, 11, d, lengths)
            kernels.reset_launch_counts()
            loss = loss_fn(params[d], batch)
            grads = torch.autograd.grad(loss, list(params[d].values()))
            counts = kernels.launch_counts()
            opts[d].functional_update(params[d], dict(zip(params[d], grads)),
                                      states[d])
            out[d] = (loss.item(), grads, counts)
        for n in expect + never:
            want = cfg.num_layers if n in expect else 0
            if out[DEV][2][n] != want:
                fail(f"phase {phase} step {step}: {n} launched "
                     f"{out[DEV][2][n]} times, expected {want}")
        rel = abs(out[DEV][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase {phase} step {step}: loss {out[DEV][0]} vs CPU "
                 f"{out['cpu'][0]} (relative {rel:.3g} > 1e-4)")
        for name, a, c in zip(params[DEV], out[DEV][1], out["cpu"][1]):
            _err, r = _rel_err(a.cpu(), c)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase {phase} step {step}: gradient {name} differs "
                     f"by {r:.3g} of its magnitude (> 1e-3)")
    limit = 2 * lr * steps + 1e-6
    for name, p in params[DEV].items():
        diff = (p.detach().cpu() - params["cpu"][name].detach()).abs().max()
        worst["param"] = max(worst["param"], diff.item())
        if diff.item() > limit:
            fail(f"phase {phase}: parameter {name} differs by "
                 f"{diff.item():.3g} after {steps} steps (> {limit:.3g})")
    return worst


def train_throughput(torch, cfg, batch_size=16, seq=1024, warm=2, steps=5,
                     lengths=None):
    """Phases 6 and 6c: the mixed-precision step on one fixed batch
    (padded to `lengths` with a mask); returns the measured numbers
    (tokens/s over padded tokens) and the launch counts of the measured
    steps."""
    from paddle_tpu_torch.ops import kernels

    step = amp_train_step(torch, cfg, _batch(torch, cfg, batch_size, seq, 0,
                                             DEV, lengths))
    losses = [step().item() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    measured = [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses += [x.item() for x in measured]
    ms = start.elapsed_time(end) / steps
    return {"losses": losses, "ms_per_step": ms,
            "tokens_per_sec": batch_size * seq * steps / (ms * steps / 1e3),
            "wall_s": wall, "peak": torch.cuda.max_memory_allocated(),
            "counts": counts}


# ---- phases 4d and 6b: BERT training ------------------------------------------

def bert_batch(torch, cfg, lens, seq, seed, dev):
    """A padded pretraining batch: random ids (pad id 0 past each length),
    token types 0 for the first half of each sequence and 1 after, MLM
    labels from create_mlm_batch (mask id 103) and random NSP labels.
    Returns the pretraining_loss arguments (input_ids, labels,
    next_sentence_label, token_type_ids, attention_mask)."""
    from paddle_tpu_torch.models.bert import create_mlm_batch

    rs = np.random.RandomState(seed)
    lens = np.asarray(lens)
    am = (np.arange(seq)[None] < lens[:, None]).astype(np.int32)
    ids = rs.randint(1, cfg.vocab_size, am.shape).astype(np.int32) * am
    tt = (np.arange(seq)[None] >= lens[:, None] // 2).astype(np.int32)
    masked, labels = create_mlm_batch(ids, cfg.vocab_size, 103,
                                      mask_prob=0.15, seed=seed)
    nsp = rs.randint(0, 2, (len(lens),)).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in (masked, labels, nsp, tt, am))


def bert_amp_train_step(torch, cfg, batch, lr=1e-4):
    """The mixed-precision BERT step on the card: the model's float32
    parameters are the masters; bf16 copies made inside the autograd
    graph are bound through functional_call for pretraining_loss on the
    padded batch (attention mask included); the loss is cast to float32;
    AdamW (wd 0.01) updates the masters in float32. Returns step() -> the
    loss tensor."""
    from paddle_tpu_torch.models.bert import Bert, pretraining_loss_with
    from paddle_tpu_torch.optimizer import AdamW

    model = Bert(cfg, device=DEV)
    model.train()
    masters = dict(model.named_parameters())
    opt = AdamW(lr, weight_decay=0.01, device=DEV)
    state = opt.functional_init(masters)

    def step():
        low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
        loss = pretraining_loss_with(model, low, *batch).float()
        grads = torch.autograd.grad(loss, list(masters.values()))
        opt.functional_update(masters, dict(zip(masters, grads)), state)
        return loss.detach()

    return step


def bert_train_parity(torch, cfg, lr=1e-4, steps=2):
    """Phase 4d: float32 AdamW steps through pretraining_loss on a padded
    batch, on the card and on the CPU from the same weights. Returns the
    worst (loss, gradient, parameter) differences."""
    from paddle_tpu_torch.models.bert import Bert, pretraining_loss_with
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    models = {DEV: Bert(cfg, device=DEV), "cpu": Bert(cfg, device="cpu")}
    params = {DEV: {n: p.detach().clone().requires_grad_(True)
                    for n, p in models[DEV].named_parameters()}}
    params["cpu"] = {n: p.detach().cpu().requires_grad_(True)
                     for n, p in params[DEV].items()}
    opts = {d: AdamW(lr, weight_decay=0.01, device=d) for d in params}
    states = {d: opts[d].functional_init(params[d]) for d in params}
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        out = {}
        for d in (DEV, "cpu"):
            batch = bert_batch(torch, cfg, [128, 77], 128, 21 + step, d)
            kernels.reset_launch_counts()
            loss = pretraining_loss_with(models[d], params[d], *batch)
            grads = torch.autograd.grad(loss, list(params[d].values()))
            counts = kernels.launch_counts()
            opts[d].functional_update(params[d], dict(zip(params[d], grads)),
                                      states[d])
            out[d] = (loss.item(), grads, counts)
        counts = out[DEV][2]
        for n in FLASH_BIAS:
            if counts[n] != cfg.num_layers:
                fail(f"phase 4d step {step}: {n} launched {counts[n]} "
                     f"times, expected {cfg.num_layers}")
        if counts["flash_fwd"] or counts["flash_bwd"]:
            fail(f"phase 4d step {step}: the unbiased kernels ran {counts}")
        rel = abs(out[DEV][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-4:
            fail(f"phase 4d step {step}: loss {out[DEV][0]} vs CPU "
                 f"{out['cpu'][0]} (relative {rel:.3g} > 1e-4)")
        # a gradient whose exact value is zero (the k_proj biases: softmax
        # is shift-invariant) is rounding noise on both sides: its scale
        # is taken as at least 1e-3 of the step's largest gradient
        floor = 1e-3 * max(g.abs().max().item() for g in out["cpu"][1])
        for name, a, c in zip(params[DEV], out[DEV][1], out["cpu"][1]):
            err = (a.cpu() - c).abs().max().item()
            r = err / max(c.abs().max().item(), floor)
            worst["grad"] = max(worst["grad"], r)
            if r > 1e-3:
                fail(f"phase 4d step {step}: gradient {name} differs by "
                     f"{r:.3g} of its magnitude (> 1e-3)")
    limit = 2 * lr * steps + 1e-6
    for name, p in params[DEV].items():
        diff = (p.detach().cpu() - params["cpu"][name].detach()).abs().max()
        worst["param"] = max(worst["param"], diff.item())
        if diff.item() > limit:
            fail(f"phase 4d: parameter {name} differs by {diff.item():.3g} "
                 f"after {steps} steps (> {limit:.3g})")
    return worst


def bert_lengths(batch_size, seq):
    """Phase 6b's padded lengths: uniform in 128..seq from RandomState(0)."""
    return np.random.RandomState(0).randint(128, seq + 1, batch_size)


def bert_train_throughput(torch, cfg, batch_size=16, seq=512, warm=2,
                          steps=5):
    """Phase 6b: the mixed-precision BERT step on a padded batch; returns
    the measured numbers and the launch counts of the measured steps."""
    from paddle_tpu_torch.ops import kernels

    lens = bert_lengths(batch_size, seq)
    step = bert_amp_train_step(torch, cfg, bert_batch(torch, cfg, lens, seq,
                                                      0, DEV))
    losses = [step().item() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()                          # main path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    measured = [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    losses += [x.item() for x in measured]
    ms = start.elapsed_time(end) / steps
    return {"losses": losses, "ms_per_step": ms,
            "tokens_per_sec": batch_size * seq / (ms / 1e3),
            "real_tokens": int(lens.sum()),
            "peak": torch.cuda.max_memory_allocated(), "counts": counts}


# ---- phase 4: decoder parity across devices --------------------------------

def decoder_parity(torch, cfg, params_gpu, kv_dtype, atol):
    """Packed prefill + 8 steps + multistep(4) on the card and on the CPU
    (teacher-forced with the card's tokens). Returns (the largest logit
    difference, the near-tie count): greedy tokens must be identical
    except where the CPU's top two logits are within 2*atol (a tie the
    summation order may break)."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    BS = 16
    rs = np.random.RandomState(3)
    lens = [150, 77, 33]
    prompts = [rs.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    T = sum(-(-n // 8) * 8 for n in lens)
    toks = np.zeros(T, np.int32)
    seg = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    sidx = np.zeros(3, np.int32)
    o = 0
    for r, p in enumerate(prompts):
        toks[o:o + p.size] = p
        seg[o:o + p.size] = r
        pos[o:o + p.size] = np.arange(p.size)
        sidx[r] = o + p.size - 1
        o += -(-p.size // 8) * 8
    sides = {}
    for dev in (DEV, "cpu"):
        params = (params_gpu if dev == DEV
                  else {k: v.cpu() for k, v in params_gpu.items()})
        cache = PagedKVCache(cfg.num_layers, H, Dh, block_size=BS,
                             num_blocks=40, dtype=torch.float32,
                             kv_dtype=kv_dtype, device=dev)
        cache.ensure_many([(r, lens[r] + 16) for r in range(3)])
        dec = PagedDecoder.for_config(cfg, BS, return_logits=True,
                                      kv_dtype=kv_dtype)
        sides[dev] = (params, cache, dec, torch.from_numpy(
            cache.table_array([0, 1, 2], 12)).to(dev))

    def tens(a, dev):
        return torch.from_numpy(np.asarray(a)).to(dev)

    ties = 0

    def compare(what, tok_gpu, lg_gpu, lg_cpu):
        nonlocal ties
        diff = (lg_gpu.cpu() - lg_cpu).abs().max().item()
        if diff > atol:
            fail(f"decoder {kv_dtype or 'dense'} {what}: logits differ by "
                 f"{diff:.3g} > {atol}")
        top = lg_cpu.argmax(-1)
        for b in range(lg_cpu.shape[0]):
            if int(top[b]) != int(tok_gpu[b]):
                gap = (lg_cpu[b, top[b]] - lg_cpu[b, int(tok_gpu[b])]).item()
                if gap > 2 * atol:
                    fail(f"decoder {kv_dtype or 'dense'} {what}: greedy "
                         f"token differs in row {b} (gap {gap:.3g})")
                ties += 1
        return diff

    worst = 0.0
    outs = {}
    for dev, (params, cache, dec, tab) in sides.items():
        outs[dev] = dec.packed_prefill(
            params, tens(toks, dev), tens(seg, dev), tens(pos, dev), tab,
            tens(sidx, dev), cache.k_blocks, cache.v_blocks,
            greedy_args(3, dev))
    tok = outs[DEV][0].cpu()
    worst = max(worst, compare("prefill", tok, outs[DEV][5],
                               outs["cpu"][5]))
    p = np.asarray(lens, np.int32)
    act = np.ones(3, bool)
    for step in range(8):
        for dev, (params, cache, dec, tab) in sides.items():
            outs[dev] = dec.step(params, tok.to(dev), tens(p, dev),
                                 tens(act, dev), tab, cache.k_blocks,
                                 cache.v_blocks, greedy_args(3, dev))
        worst = max(worst, compare(f"step {step}", outs[DEV][0].cpu(),
                                   outs[DEV][5], outs["cpu"][5]))
        tok = outs[DEV][0].cpu()
        p = p + 1
    multi = {}
    for dev, (params, cache, dec, tab) in sides.items():
        multi[dev] = dec.multistep(4)(
            params, tok.to(dev), tens(p, dev), tens(act, dev), tab,
            cache.k_blocks, cache.v_blocks, greedy_args(3, dev))[0].cpu()
    if not torch.equal(multi[DEV], multi["cpu"]):
        fail(f"decoder {kv_dtype or 'dense'} multistep(4): tokens differ "
             f"{multi[DEV].tolist()} vs {multi['cpu'].tolist()}")
    return worst, ties


# ---- phase 5: serving ---------------------------------------------------------

def serve(torch, model, prompts, k):
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.ops import kernels

    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=768, max_new_tokens=32,
                                prefill_chunk_tokens=512,
                                steps_per_dispatch=k, device=DEV).start()
    try:
        for f in [srv.submit(p) for p in prompts]:        # warm pass
            f.result(timeout=600)
        srv.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()                      # main path
        outs = [f.result(timeout=600) for f in
                [srv.submit(p) for p in prompts]]
        counts = kernels.launch_counts()
        st = srv.stats()
    finally:
        srv.stop()
    V = model.cfg.vocab_size
    for p, o in zip(prompts, outs):
        if o.shape != (p.size + 32,) or not (o[:p.size] == p).all() \
                or o[p.size:].min() < 0 or o[p.size:].max() >= V:
            fail(f"serving k={k}: bad output for a {p.size}-token prompt")
    L = model.cfg.num_layers
    need_k1 = L * st["prefill_dispatches"]
    need_k2 = L * st["decode_steps"] * k
    if counts["ragged_stream_dense"] < need_k1 or need_k1 == 0:
        fail(f"serving k={k}: K1 ran {counts['ragged_stream_dense']} times,"
             f" expected >= {need_k1}")
    if counts["paged_decode_dense"] < need_k2 or need_k2 == 0:
        fail(f"serving k={k}: K2 ran {counts['paged_decode_dense']} times,"
             f" expected >= {need_k2}")
    return st, counts, torch.cuda.max_memory_allocated()


def main():
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        say("FAIL device: torch.cuda.is_available() is False "
            "(chip_smoke needs a CUDA card)")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 comparisons
    torch.backends.cudnn.allow_tf32 = False        # are full float32

    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.ops import kernels

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    say(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib_path, REPO)}")

    # phase 3: kernels vs plain
    timer = Timer(torch)
    rows = {}
    for quant in (False, True):
        tag = "int8" if quant else "dense"
        r2 = decode_case(torch, timer, 12, 64, 16, quant, 1, True)
        r2b = decode_case(torch, timer, 12, 64, 128, quant, 2, False)
        r2t = decode_case(torch, timer, 4, 32, 4, quant, 3, False)
        r1 = stream_case(torch, timer, 12, 64, 16, quant, 4, True)
        r1t = stream_case(torch, timer, 4, 32, 4, quant, 5, False)
        for name, r in ((f"K2 {tag} H12 Dh64 BS16", r2),
                        (f"K2 {tag} H12 Dh64 BS128", r2b),
                        (f"K2 {tag} H4 Dh32 BS4", r2t),
                        (f"K1 {tag} H12 Dh64 BS16 T{r1['tokens']}", r1),
                        (f"K1 {tag} H4 Dh32 BS4", r1t)):
            if not r["ok"]:
                fail(f"phase 3 {name}: kernel disagrees with plain "
                     f"(max abs err {r['max_abs_err']:.3g}, atol=rtol=2e-2)")
        for name, r in ((f"paged_decode_{tag}", r2),
                        (f"ragged_stream_{tag}", r1)):
            rows[name] = r
            say(f"phase 3 {name}: max_abs_err {r['max_abs_err']:.3g} "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library (SDPA, gather excluded) {r['library_ms']:.4f} "
                f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                f"[{card}]")

    # phase 3b: flash kernels vs plain
    both, bf16 = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    for b, h, sq, sk, d, causal, timed, dtypes in (
            (16, 12, 1024, 1024, 64, True, True, both),
            (2, 4, 1000, 1000, 32, True, False, both),
            (2, 4, 1000, 1000, 32, False, False, both),
            (2, 8, 2048, 2048, 128, True, False, bf16),
            (2, 4, 384, 256, 64, True, False, bf16)):  # dead rows
        for dtype in dtypes:
            r = flash_case(torch, timer, b, h, sq, sk, d, causal, dtype,
                           b * sq + d, timed and dtype == torch.bfloat16)
            if timed and dtype == torch.bfloat16:
                rows.update(r)
    torch.cuda.empty_cache()

    # phase 3c: per-key-bias flash kernels vs plain
    for b, h, sq, sk, d, causal, kind in (
            (16, 16, 512, 512, 64, False, "lengths"),
            (2, 4, 300, 300, 32, True, "lengths"),
            (2, 4, 256, 384, 64, False, "lengths"),
            (2, 4, 256, 256, 64, False, "broadcast"),
            (2, 4, 256, 256, 32, False, "dead_row"),
            (2, 4, 256, 256, 32, True, "dead_row")):
        for dtype in (torch.bfloat16, torch.float32):
            timed = b == 16 and dtype == torch.bfloat16
            r = bias_flash_case(torch, timer, b, h, sq, sk, d, causal, kind,
                                dtype, b * sq + sk + d, timed)
            if timed:
                rows.update(r)
    torch.cuda.empty_cache()

    # phase 3d: the two-pass backward (K7, K8, bias variants) vs plain
    for b, h, sq, sk, d, causal, kind, dtypes, external in (
            (16, 12, 1024, 1024, 64, True, None, both, False),      # (a)
            (1, 2, 16384, 16384, 64, True, None, bf16, False),      # (b)
            (2, 4, 1000, 1000, 32, True, None, both, False),        # (c)
            (2, 4, 1000, 1000, 32, False, None, both, False),
            (2, 4, 256, 384, 64, False, None, both, False),         # (d)
            (2, 4, 256, 256, 64, False, None, both, True),          # (e)
            (16, 16, 512, 512, 64, False, "lengths", both, False),  # (f)
            (2, 4, 300, 300, 32, True, "lengths", both, False),
            (2, 4, 256, 384, 64, False, "lengths", both, False),
            (2, 4, 256, 256, 64, False, "broadcast", both, False),
            (2, 4, 256, 256, 32, False, "dead_row", both, False),
            (2, 4, 256, 256, 32, True, "dead_row", both, False)):
        for dtype in dtypes:
            timed = b == 16 and dtype == torch.bfloat16
            r = two_pass_case(torch, timer, b, h, sq, sk, d, causal, kind,
                              dtype, b * sq + sk + d, timed, external)
            if timed:
                rows.update(r)
        torch.cuda.empty_cache()
    # (f) phase 6c's padded batch, its mask and per-row bias, at H 2
    two_pass_case(torch, timer, 2, 2, 16384, 16384, 64, True, "lengths",
                  torch.bfloat16, 7, False, lengths=(16384, 10240))
    torch.cuda.empty_cache()

    # phase 4: decoder parity, GPT-2 small float32, card vs CPU
    cfg = GPT2Config()  # GPT-2 small, full width and depth
    model32 = GPT2(cfg, seed=0, dtype=torch.float32, device=DEV)
    params32 = model32.flat_params()
    main_counts = {}
    for kv_dtype, atol in ((None, 2e-3), ("int8", 2e-2)):
        kernels.reset_launch_counts()
        worst, ties = decoder_parity(torch, cfg, params32, kv_dtype, atol)
        counts = kernels.launch_counts()
        if kv_dtype == "int8":
            main_counts["ragged_stream_int8"] = \
                counts["ragged_stream_int8"]
            main_counts["paged_decode_int8"] = counts["paged_decode_int8"]
        if min(v for n, v in counts.items()
               if n.endswith(kv_dtype or "dense")) == 0:
            fail(f"phase 4 {kv_dtype}: a kernel was not launched {counts}")
        say(f"phase 4 decoder {kv_dtype or 'dense'} f32: max logit diff "
            f"{worst:.3g} (atol {atol}), near-ties {ties}, launches "
            f"{counts}")
    del model32, params32
    torch.cuda.empty_cache()

    # phase 4c: training parity, GPT-2 small float32, card vs CPU
    cfg_train = GPT2Config(dropout=0.0)
    t0 = time.perf_counter()
    worst = train_parity(torch, cfg_train)
    say(f"phase 4c train parity f32 B2 S256, 2 AdamW steps: loss rel diff "
        f"{worst['loss']:.3g} (limit 1e-4), worst gradient diff "
        f"{worst['grad']:.3g} of its magnitude (limit 1e-3), worst "
        f"parameter diff {worst['param']:.3g} (limit 4.01e-4), K4/K6/K9 "
        f"12 launches each per step, {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 4d: BERT training parity, BERT-large float32, card vs CPU
    from paddle_tpu_torch.models.bert import BertConfig

    bert_cfg = BertConfig.large()
    bert_cfg.dropout = 0.0
    t0 = time.perf_counter()
    worst = bert_train_parity(torch, bert_cfg)
    say(f"phase 4d BERT-large ({bert_cfg.num_layers} layers) train parity "
        f"f32 B2 S128 lengths 128/77, 2 AdamW steps: loss rel diff "
        f"{worst['loss']:.3g} (limit 1e-4), worst gradient diff "
        f"{worst['grad']:.3g} of its magnitude (limit 1e-3), worst "
        f"parameter diff {worst['param']:.3g} (limit 4.01e-4), K4 bias/K6/"
        f"K9 bias {bert_cfg.num_layers} launches each per step, unbiased "
        f"K4/K9 none, {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 4e: long-context training parity past the switch, card vs CPU
    S = 13312
    cfg_long = GPT2Config(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=2, max_position=S, dropout=0.0)
    for lengths, expect in ((None, TWO_PASS), ([9000], TWO_PASS_BIAS)):
        t0 = time.perf_counter()
        worst = train_parity(torch, cfg_long, b=1, s=S, lengths=lengths,
                             expect=expect, never=FUSED_BWD, phase="4e")
        say(f"phase 4e long-context train parity f32 B1 S{S} "
            f"{'padded to 9000' if lengths else 'unpadded'}, 2 layers, 2 "
            f"AdamW steps: loss rel diff {worst['loss']:.3g} (limit 1e-4), "
            f"worst gradient diff {worst['grad']:.3g} of its magnitude "
            f"(limit 1e-3), worst parameter diff {worst['param']:.3g} "
            f"(limit 4.01e-4), {'/'.join(expect)} "
            f"{cfg_long.num_layers} launches each per step, K9/K9 bias "
            f"none, {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    # phase 5: serving, GPT-2 small bf16
    model = GPT2(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size,
                           (int(rng.randint(64, 769)),)).astype(np.int32)
               for _ in range(16)]
    main_counts["ragged_stream_dense"] = 0
    main_counts["paged_decode_dense"] = 0
    for k in (1, 8):
        st, counts, peak = serve(torch, model, prompts, k)
        for n in ("ragged_stream_dense", "paged_decode_dense"):
            main_counts[n] += counts[n]
        say(f"phase 5 serving k={k}: tokens_per_sec "
            f"{st['tokens_per_sec']:.1f} ttft p50/p99 "
            f"{st['ttft_p50_ms']:.1f}/{st['ttft_p99_ms']:.1f} ms itl "
            f"p50/p99 {st['itl_p50_ms']:.2f}/{st['itl_p99_ms']:.2f} ms "
            f"requests {st['requests']} new_tokens {st['new_tokens']} "
            f"prefill_dispatches {st['prefill_dispatches']} decode "
            f"dispatches {st['decode_steps']} launches K1 "
            f"{counts['ragged_stream_dense']} K2 "
            f"{counts['paged_decode_dense']} max_memory_allocated "
            f"{peak / 2**20:.0f} MiB [{card}]")

    del model
    torch.cuda.empty_cache()

    # phase 6: training throughput, GPT-2 small, bf16 on float32 masters
    steps = 5
    tr = train_throughput(torch, cfg_train, steps=steps)
    losses = tr["losses"]
    if not all(np.isfinite(losses)):
        fail(f"phase 6: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 6: loss did not fall ({losses[0]} -> {losses[-1]})")
    for n in FLASH:
        want = cfg_train.num_layers * steps
        if tr["counts"][n] != want:
            fail(f"phase 6: {n} launched {tr['counts'][n]} times in "
                 f"{steps} steps, expected {want}")
        main_counts[n] = tr["counts"][n]
    say(f"phase 6 training B16 S1024 bf16/f32-master AdamW: tokens_per_sec "
        f"{tr['tokens_per_sec']:.1f} ms_per_step {tr['ms_per_step']:.2f} "
        f"(wall {tr['wall_s']:.2f} s for {steps} steps) "
        f"max_memory_allocated {tr['peak'] / 2**20:.0f} MiB loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} launches "
        f"{ {n: tr['counts'][n] for n in FLASH} } [{card}]")
    torch.cuda.empty_cache()

    # phase 6b: BERT-large training on padded batches, bf16 on f32 masters;
    # 13 measured steps, so the loss is read past its early spike
    steps = 13
    tr = bert_train_throughput(torch, bert_cfg, steps=steps)
    losses = tr["losses"]
    if not all(np.isfinite(losses)):
        fail(f"phase 6b: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 6b: loss did not fall ({losses[0]} -> {losses[-1]})")
    for n in FLASH_BIAS:
        want = bert_cfg.num_layers * steps
        if tr["counts"][n] != want:
            fail(f"phase 6b: {n} launched {tr['counts'][n]} times in "
                 f"{steps} steps, expected {want}")
    for n in ("flash_fwd_bias", "flash_bwd_bias", "flash_delta"):
        main_counts[n] = main_counts.get(n, 0) + tr["counts"][n]
    say(f"phase 6b BERT-large training B16 S512 (padded; {tr['real_tokens']} "
        f"real tokens a step) bf16/f32-master AdamW: tokens_per_sec "
        f"{tr['tokens_per_sec']:.1f} ms_per_step {tr['ms_per_step']:.2f} "
        f"max_memory_allocated {tr['peak'] / 2**20:.0f} MiB loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} launches "
        f"{ {n: tr['counts'][n] for n in FLASH_BIAS} } unbiased "
        f"{ {n: tr['counts'][n] for n in ('flash_fwd', 'flash_bwd')} } "
        f"[{card}]")
    torch.cuda.empty_cache()

    # phase 6c: long-context GPT-2 small training, through K7/K8 (bias)
    cfg_16k = GPT2Config(max_position=16384, dropout=0.0)
    for b, lengths, steps, names in ((1, None, 3, TWO_PASS),
                                     (2, [16384, 10240], 2, TWO_PASS_BIAS)):
        tr = train_throughput(torch, cfg_16k, batch_size=b, seq=16384,
                              warm=1, steps=steps, lengths=lengths)
        losses = tr["losses"]
        tag = f"B{b} S16384" + (" padded to 16384/10240" if lengths else "")
        if not all(np.isfinite(losses)):
            fail(f"phase 6c {tag}: non-finite loss {losses}")
        for n in names + FUSED_BWD:
            want = cfg_16k.num_layers * steps if n in names else 0
            if tr["counts"][n] != want:
                fail(f"phase 6c {tag}: {n} launched {tr['counts'][n]} "
                     f"times in {steps} steps, expected {want}")
        for n in names:
            main_counts[n] = main_counts.get(n, 0) + tr["counts"][n]
        say(f"phase 6c long-context training {tag} bf16/f32-master AdamW: "
            f"tokens_per_sec {tr['tokens_per_sec']:.1f} ms_per_step "
            f"{tr['ms_per_step']:.2f} max_memory_allocated "
            f"{tr['peak'] / 2**20:.0f} MiB losses "
            f"{' '.join(f'{x:.4f}' for x in losses)} launches "
            f"{ {n: tr['counts'][n] for n in names + FUSED_BWD} } [{card}]")
        torch.cuda.empty_cache()

    # phase 7: the kernels line
    out = []
    for name, replaces in (("ragged_stream_dense", K1_REPLACES),
                           ("ragged_stream_int8", K1_REPLACES),
                           ("paged_decode_dense", K2_REPLACES),
                           ("paged_decode_int8", K2_REPLACES)):
        r = rows[name]
        if main_counts[name] <= 0:
            fail(f"{name} was not launched on the main path")
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": replaces, "launches": main_counts[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    for name in FLASH + ("flash_fwd_bias", "flash_bwd_bias") + \
            TWO_PASS[2:] + TWO_PASS_BIAS[2:]:
        r = rows[name]
        if main_counts[name] <= 0:
            fail(f"{name} was not launched on the main path")
        # the rows are timed in bf16: K4 and K9 (bias) run their sm90 units
        src = (TWO_PASS_SOURCE if "_bwd_d" in name else
               FWD_SOURCE if name.startswith("flash_fwd") else
               BWD_SOURCE if name.startswith("flash_bwd") else FLASH_SOURCE)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": FLASH_REPLACES[name],
                    "launches": main_counts[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": out}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
