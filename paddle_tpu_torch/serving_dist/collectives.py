"""Quantized TP collectives of the sharded decode path.

The port of `paddle_tpu/serving_dist/collectives.py`. A sharded decode
pays one all-reduce a half-block (the row-split out_proj and fc2), one
for the vocab-parallel embedding, and an all-gather of the vocab-split
head logits a sampled token. `collective_quant="int8"` / `"int4g"` ships
codes and scales instead of the compute dtype:

  * `matmul_psum` — the row-split product's reduction: each rank's
    partial [rows, E] is cut into tp chunks, each quantized with its own
    absmax scale (int4g: a scale every `group` lanes, two codes a byte),
    the chunks go to their owners by all-to-all, each owner decodes and
    SUMS IN float32 in rank order, re-quantizes its reduced chunk once,
    and an all-gather brings every chunk back;
  * `embed_psum` — the vocab-parallel embedding's sum through the same
    wire (each rank contributes the rows its vocabulary slice holds);
  * `greedy_tokens` — the all-greedy readout exchanges (max, first
    global index) pairs instead of logits: LOSSLESS, the argmax of the
    gathered logits with the first-index tie-break;
  * `gather_logits` — the codes + scales all-gather of the logits for the
    sampled modes.

The reference computes these in XLA inside shard_map bodies; the port
runs the same arithmetic in torch over `parallel.comm` on the mesh's mp
group. There is no kernel here. The wire-byte formulas are host-side
arithmetic that mirrors the seams element for element; the decoder
counts, per dispatch, the bytes the path shipped and the bytes the
unquantized collectives would have (dtype "baseline").
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..observability import metrics as _metrics

MODES = ("int8", "int4g")

ROW_PSUM = "row_psum"
EMBED_PSUM = "embed_psum"
LOGITS_GATHER = "logits_gather"
LOGITS_ARGMAX = "logits_argmax"

_SCALE_BYTES = 4  # scales ship float32

_m_collective_bytes = _metrics.counter(
    "serving_collective_bytes_total",
    "analytic per-rank wire bytes of the sharded decode collectives "
    "(dtype=baseline is what the unquantized collectives would ship "
    "for the same dispatches)",
    labelnames=("collective", "dtype"))


def record_wire_bytes(bytes_by_key):
    """One dispatch's {(collective, dtype): bytes} into the metrics
    registry (one bool check while telemetry is off)."""
    if not _metrics.enabled():
        return
    for (name, dtype), nbytes in bytes_by_key.items():
        _m_collective_bytes.labels(collective=name, dtype=dtype).inc(
            nbytes)


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def normalize_collective_quant(mode):
    """Validate a `collective_quant` value (None passes through)."""
    if mode is not None and mode not in MODES:
        raise ValueError(
            f"ShardedEngineConfig.collective_quant={mode!r} must be one "
            f"of {(None,) + MODES}")
    return mode


# ---- quantize / dequantize -------------------------------------------------

def group_size(width, group):
    """The scale-group width: `group` snapped to a divisor of `width`."""
    return math.gcd(int(width), int(group)) or 1


def encode_int8(x, group=None):
    """[..., C] -> (int8 codes [..., C], float32 scales [..., C/g]):
    symmetric absmax per group (group=None: one scale a vector)."""
    C = x.shape[-1]
    g = C if group is None else group_size(C, group)
    xg = x.float().reshape(x.shape[:-1] + (C // g, g))
    amax = xg.abs().amax(dim=-1, keepdim=True)
    sc = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xg / sc), -127, 127).to(torch.int8)
    return codes.reshape(x.shape), sc.squeeze(-1)


def decode_int8(codes, scales, group=None):
    """Inverse of encode_int8 -> float32."""
    C = codes.shape[-1]
    g = C if group is None else group_size(C, group)
    cg = codes.reshape(codes.shape[:-1] + (C // g, g))
    return (cg.float() * scales[..., None]).reshape(codes.shape)


def encode_int4(x, group):
    """[..., C] -> (uint8 codes [..., C/2], float32 scales [..., C/g]):
    two's-complement nibbles in [-7, 7], even lane in the low nibble."""
    C = x.shape[-1]
    _require(C % 2 == 0, f"int4 packing needs an even width, got {C}")
    g = group_size(C, group)
    xg = x.float().reshape(x.shape[:-1] + (C // g, g))
    amax = xg.abs().amax(dim=-1, keepdim=True)
    sc = torch.clamp(amax, min=1e-12) / 7.0
    q = torch.clamp(torch.round(xg / sc), -7, 7).to(torch.int16) \
        .reshape(x.shape)
    packed = ((q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)) \
        .to(torch.uint8)
    return packed, sc.squeeze(-1)


def decode_int4(packed, scales, group, width):
    """Inverse of encode_int4 -> float32 [..., width]."""
    p = packed.to(torch.int16)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    q = torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (width,))
    g = group_size(width, group)
    qg = q.reshape(q.shape[:-1] + (width // g, g))
    return (qg.float() * scales[..., None]).reshape(q.shape)


def _wire_encode(x, mode, group):
    if mode == "int8":
        return encode_int8(x)
    return encode_int4(x, group)


def _wire_decode(codes, scales, mode, group, width):
    if mode == "int8":
        return decode_int8(codes, scales)
    return decode_int4(codes, scales, group, width)


# ---- wire-byte formulas -----------------------------------------------------

def _hop_bytes(nvec, width, mode, group):
    """Codes + scales of `nvec` vectors of `width` lanes on one hop."""
    if mode == "int8":
        return nvec * width + nvec * _SCALE_BYTES
    g = group_size(width, group)
    return nvec * width // 2 + nvec * (width // g) * _SCALE_BYTES


def psum_wire_bytes(nrows, width, tp, mode, group, base_itemsize):
    """(actual, baseline) per-rank wire bytes of one all-reduce of an
    [nrows, width] partial: baseline the ring all-reduce, 2 (n-1)/n of
    the data; quantized the all-to-all of tp chunks plus the all-gather
    of the reduced chunk."""
    if tp <= 1:
        return 0, 0
    base = int(2 * (tp - 1) * nrows * width * base_itemsize // tp)
    if mode is None:
        return base, base
    chunk = width // tp
    p1 = _hop_bytes(nrows * tp, chunk, mode, group) * (tp - 1) // tp
    p2 = _hop_bytes(nrows, chunk, mode, group) * (tp - 1)
    return int(p1 + p2), base


def gather_wire_bytes(nrows, vocab, tp, mode, group):
    """(actual, baseline) per-rank bytes of the vocab-parallel logits
    all-gather (float32 baseline)."""
    if tp <= 1 or vocab % tp:
        return 0, 0
    base = int((tp - 1) * nrows * vocab * 4 // tp)
    if mode is None:
        return base, base
    return int(_hop_bytes(nrows, vocab // tp, mode, group)
               * (tp - 1)), base


def argmax_wire_bytes(nrows, vocab, tp):
    """(actual, baseline) of the greedy exchange: one (float32 max,
    int32 index) pair a row per peer instead of the logits row."""
    if tp <= 1 or vocab % tp:
        return 0, 0
    base = int((tp - 1) * nrows * vocab * 4 // tp)
    return int((tp - 1) * nrows * 8), base


# ---- the seams --------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CollectiveQuant:
    """The quantized-collective seams over the mp group of `mesh`."""

    mode: str            # "int8" | "int4g"
    tp: int
    mesh: object         # parallel.mesh.Mesh
    group: int = 32      # int4g scale-group width
    axis: str = "mp"

    def __post_init__(self):
        _require(self.mode in MODES,
                 f"CollectiveQuant.mode={self.mode!r} must be one of "
                 f"{MODES}")
        _require(isinstance(self.tp, int) and self.tp > 1,
                 f"CollectiveQuant.tp={self.tp!r} must be an int > 1 "
                 f"(tp=1 has no wire — pass collective_quant=None)")
        _require(isinstance(self.group, int) and self.group >= 1,
                 f"CollectiveQuant.group={self.group!r} must be a "
                 f"positive int")

    def _pg(self):
        return self.mesh.group(self.axis)

    def _quantized_psum(self, x):
        """all-to-all + float32 sum + all-gather of one rank's partial
        [..., width]; the reduced value in x's dtype, equal on every
        rank of the group."""
        from ..parallel import comm

        n, pg = self.tp, self._pg()
        width = x.shape[-1]
        lead = tuple(x.shape[:-1])
        xr = x.reshape(lead + (n, width // n)).movedim(-2, 0)
        codes, sc = _wire_encode(xr, self.mode, self.group)
        codes = comm.all_to_all_single(codes, pg)
        sc = comm.all_to_all_single(sc, pg)
        part = _wire_decode(codes, sc, self.mode, self.group,
                            width // n).sum(dim=0)
        codes2, sc2 = _wire_encode(part, self.mode, self.group)
        codes2 = torch.stack(comm.all_gather(codes2, pg))
        sc2 = torch.stack(comm.all_gather(sc2, pg))
        full = _wire_decode(codes2, sc2, self.mode, self.group, width // n)
        return full.movedim(0, -2).reshape(lead + (width,)).to(x.dtype)

    def matmul_psum(self, x, w, cast=None):
        """x [..., K/tp] @ w [K/tp, N] (this rank's rows), reduced through
        the quantized wire -> [..., N] on every rank. `cast`: the W8A16
        codes' compute dtype (the per-column scales apply after)."""
        if cast is not None:
            w = w.to(cast)
        return self._quantized_psum(x @ w)

    def embed_psum(self, ids, table, v_off, scales=None, dt=None):
        """Vocab-parallel embedding through the wire: `table` is this
        rank's rows [V/tp, E] (W8A16: int8 codes with per-row `scales`),
        `v_off` their first id. Returns [..., E] in `dt`."""
        vs = table.shape[0]
        loc = ids.long() - v_off
        ok = (loc >= 0) & (loc < vs)
        idx = loc.clamp(0, vs - 1)
        rows = table[idx]
        if scales is not None:
            rows = rows.to(dt) * scales[idx][..., None].to(dt)
        elif dt is not None:
            rows = rows.to(dt)
        part = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        return self._quantized_psum(part)

    def greedy_tokens(self, logits):
        """LOSSLESS vocab-parallel argmax of this rank's [R, V/tp]
        float32 logits: (max, first global index) pairs are exchanged;
        the global max's smallest index wins, as argmax of the gathered
        row would."""
        from ..parallel import comm

        pg = self._pg()
        vs = logits.shape[-1]
        V = vs * self.tp
        gi = logits.argmax(dim=-1) + self.mesh.axis_index(self.axis) * vs
        vals = torch.stack(comm.all_gather(logits.amax(dim=-1), pg))
        idxs = torch.stack(comm.all_gather(gi, pg))            # [n, R]
        gmax = vals.amax(dim=0)
        cand = torch.where(vals >= gmax[None], idxs,
                           torch.full_like(idxs, V))
        return cand.amin(dim=0).to(torch.int32)

    def gather_logits(self, logits):
        """Codes + scales all-gather of this rank's [R, V/tp] float32
        logits -> [R, V] float32 on every rank."""
        from ..parallel import comm

        pg = self._pg()
        vs = logits.shape[-1]
        codes, sc = _wire_encode(logits, self.mode, self.group)
        codes = comm.all_gather(codes, pg)
        sc = comm.all_gather(sc, pg)
        return torch.cat([_wire_decode(c, s, self.mode, self.group, vs)
                          for c, s in zip(codes, sc)], dim=-1)

    def vocab_sharded(self, vocab):
        return int(vocab) % self.tp == 0


def build_collective_quant(cfg, mesh):
    """A CollectiveQuant for a config whose `collective_quant` is set
    and whose tp > 1; None otherwise (tp = 1 has no wire)."""
    mode = normalize_collective_quant(
        getattr(cfg, "collective_quant", None))
    if mode is None or cfg.tp <= 1:
        return None
    return CollectiveQuant(mode=mode, tp=cfg.tp, mesh=mesh,
                           group=getattr(cfg, "int4_group", 32))


def dispatch_wire_bytes(*, spec, vocab, tp, mode, group, trunk_rows,
                        logit_rows, greedy_fast, base_itemsize):
    """{(collective, dtype): bytes} one decode dispatch ships on the path
    taken (`mode` None = unquantized), beside the unquantized baseline
    under dtype "baseline". trunk_rows: token rows through the trunk (2L
    row all-reduces of [rows, E], plus the embedding's when the
    vocabulary is split); logit_rows: the head's readout rows;
    greedy_fast: the argmax exchange replaced the logits gather."""
    L, _H, _Dh, E, _eps, _tied = spec
    out = {}
    dtype = mode or "base"

    def add(name, actual, baseline):
        if baseline or actual:
            out[(name, dtype)] = out.get((name, dtype), 0) + actual
            out[(name, "baseline")] = (out.get((name, "baseline"), 0)
                                       + baseline)

    a, b = psum_wire_bytes(trunk_rows, E, tp, mode, group, base_itemsize)
    add(ROW_PSUM, a * 2 * L, b * 2 * L)
    if int(vocab) % tp == 0:
        a, b = psum_wire_bytes(trunk_rows, E, tp, mode, group,
                               base_itemsize)
        add(EMBED_PSUM, a, b)
        if greedy_fast and mode is not None:
            a, b = argmax_wire_bytes(logit_rows, vocab, tp)
            add(LOGITS_ARGMAX, a, b)
        else:
            a, b = gather_wire_bytes(logit_rows, vocab, tp, mode, group)
            add(LOGITS_GATHER, a, b)
    return out


__all__ = ["MODES", "CollectiveQuant", "build_collective_quant",
           "normalize_collective_quant", "group_size", "encode_int8",
           "decode_int8", "encode_int4", "decode_int4", "psum_wire_bytes",
           "gather_wire_bytes", "argmax_wire_bytes", "dispatch_wire_bytes",
           "record_wire_bytes"]
