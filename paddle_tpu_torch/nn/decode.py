"""The paged decode engine: GPT-2-layout decoder programs over the
block-pool KV cache (`inference/kv_cache.py`).

The port of `paddle_tpu.nn.decode`'s serving programs:

  * `prefill` — the padded prefill of the offline paged generate
    (`GPT2.generate(kv_cache="paged")`): right-padded ids [B, S0] with
    lengths [B], causal attention masked by length as dense products
    (the reference computes it in XLA, outside any Pallas kernel),
    writes past a row's length routed to the trash block, the readout
    at each row's last prompt token;
  * `step` — one token per sequence against the paged cache via
    `ops.paged_decode_attention` (kernel K2 on the card), writing the
    incoming token's K/V at its cache position;
  * `packed_prefill` — ONE dispatch over a token-packed multi-sequence
    chunk stream (segment-causal attention via
    `ops.ragged_prefill_attention`, kernel K1 on the card). A chunk's
    tokens attend whatever K/V the block tables reach at positions
    <= pos, so a prompt split across chunks needs no state beyond the
    paged cache;
  * `multistep(n, mode)` — n decode tokens per call, a Python loop over
    `step` (the reference's `lax.scan`), advancing each row's PRNG step
    with the loop index and threading the count buffer. On the card the
    server runs it through `graphs` (`nn/decode_graph.py`): the loop is
    captured once per key as one CUDA graph and replayed, one launch a
    dispatch, as the reference's jitted scan is one device program;
  * `packed_verify` — speculative verification: a stream of pinned
    W-token regions, [last token, draft_1 .. draft_k] per speculating
    slot, scored in one dispatch over the verify trunk (attention through
    `ops.verify_window_attention`: K1 on the card), with a [P, K+1]
    readout and ON-DEVICE acceptance. The PRNG is counter-based, so the
    target's token at every position is deterministic: draft j is
    accepted iff it equals the token sampled at position j-1 and every
    earlier draft was accepted. On the card the server replays it as one
    graph (its shapes are pinned by the plan);
  * `unified_round` — prefill chunk rows, decode rows and verify regions
    of a whole scheduler round in ONE dispatch, with the verify readout
    and a slot-indexed device carry (next token, write position and PRNG
    step per slot) that chains round N's samples into round N+1 without
    a host read. `window=True` (no chunk row: every row one W-token
    region) runs the verify trunk and replays as a graph on the card;
    `window=False` runs the packed trunk eagerly (its stream length
    varies, as the packed prefill's; `ops.unified_stream_attention`, the
    reference's name for the mixed stream's attention, is the packed
    trunk's `ragged_prefill_attention`).

Params are the flat GPT-2 dict (`models.gpt2.GPT2.flat_params()`), every
projection `[in, out]` applied as `x @ W`. Masking is by LENGTH
everywhere; padded stream tokens and idle decode slots write to the
reserved trash block 0 (several pad rows may write the same trash row —
its content is then undefined, and nothing reads block 0 unmasked).

Where the reference scatters functionally and returns new cache arrays,
the port writes the pool IN PLACE (`index_put_`) and returns the same
tensors, so a dispatch never copies the pool. int8 pools
(`QuantizedKV`, `kv_dtype="int8"`) quantize each written K/V vector on
append (`inference.kv_quant.kv_encode`) and the attention ops dequantize
inside the kernel.

Readout is `sampling.processors.sample_tokens` under the dispatch's
`mode` = (sampled, penalties), the reference's variant selector:
`GREEDY_MODE` is a bare argmax. In penalty mode the 5th result is the
updated [slots, V] count buffer (None otherwise).

W8A16 params (`models.gpt2.GPT2.quantize_weights`: `name::w8c` int8
codes and `name::w8s` scales in place of a weight) make every program a
W8A16 one through `_LayerHelpers.matw`, as the reference's `matw`:
`(x @ codes.to(dt)) * scale.to(dt)` per output column, the embedding
`codes[t] * scale[t]` per row, and the tied head with wte's row scales
on its output columns. The product stays a `torch.matmul`: the
reference computes it in XLA, outside any Pallas kernel.

Sharded serving (`serving_dist`): `PagedDecoder(..., shard=...)` takes a
rank's shard context (its mesh, the quantized-collective seams, the sp
mode) and runs every program on the rank's slices. Attention and the
pool hold H/tp heads; `_ShardedHelpers` sums the row-split out_proj and
fc2 partials over mp (one all-reduce each, the bias added once after the
sum; `collective_quant` routes it through the quantized wire), and with
a vocabulary tp divides runs the vocab-parallel embedding (a masked
gather and a sum) and head (the logits all-gathered before sampling, so
every rank samples from the same logits; the greedy quantized path
exchanges argmax pairs instead). With sp > 1 the packed trunk
(`_sp_trunk`) runs each rank's T/sp rows: K/V are all-gathered over sp
before the pool write (the pool is replicated over sp) and K1 runs on
the rank's own rows with the global block tables, or the ring/ulysses
attention of `serving_dist.sp_attention` takes the layer. Without a
shard context every program is the unsharded one, unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import (paged_decode_attention, ragged_prefill_attention,
                             verify_window_attention)
from ..sampling import processors as _proc
from ..sampling.buffers import GREEDY_MODE
from .decode_graph import DecodeGraphs


def _kv_io(kv_quant):
    """(write, layer) accessors over the cache tensors. Dense pools are
    [L, N, BS, H, Dh] tensors; int8 pools are `QuantizedKV` (codes,
    per-vector scales). `write` updates the pool in place and returns
    it; `layer` is one layer's view for the attention ops."""
    if not kv_quant:
        def write(cache, i, blk, off, t):
            cache[i].index_put_((blk, off), t.to(cache.dtype))
            return cache

        def layer(cache, i):
            return cache[i]
    else:
        # imported here: the inference package imports this module
        from ..inference.kv_quant import QuantizedKV, kv_encode

        def write(cache, i, blk, off, t):
            codes, sc = kv_encode(t, cache.scales.dtype)
            cache.codes[i].index_put_((blk, off), codes)
            cache.scales[i].index_put_((blk, off), sc)
            return cache

        def layer(cache, i):
            return QuantizedKV(cache.codes[i], cache.scales[i])
    return write, layer


class _LayerHelpers:
    """GPT-2-layout building blocks shared by every program: layernorm
    (population variance, as the reference's `ln`), the int8-aware
    product `matw`, qkv split, embed/head and residual+MLP. spec = (L, H,
    Dh, E, eps, tied)."""

    def __init__(self, spec):
        self.L, self.H, self.Dh, self.E, self.eps, self.tied = spec
        self.Ea = self.H * self.Dh  # the attention width (E unsharded)

    def ln(self, x, w, b):
        return F.layer_norm(x, (self.E,), w, b, self.eps)

    @staticmethod
    def matw(p, name, x):
        """x @ W for a `[in, out]` weight, or for W8A16 params
        (`name::w8c` int8 codes, `name::w8s` per-output-column scales)
        the reference's `(x @ codes.astype(dt)) * scale.astype(dt)`: the
        scale applies after the product, dt is x's dtype."""
        codes = p.get(name + "::w8c")
        if codes is None:
            return x @ p[name]
        dt = x.dtype
        return (x @ codes.to(dt)) * p[name + "::w8s"].to(dt)

    def qkv_split(self, p, i, a):
        qkv = self.matw(p, f"h.{i}.qkv_proj.weight", a) \
            + p[f"h.{i}.qkv_proj.bias"]
        q, k, v = torch.split(qkv, self.Ea, dim=-1)
        new = q.shape[:-1] + (self.H, self.Dh)
        return q.reshape(new), k.reshape(new), v.reshape(new)

    def embed(self, p, t):
        t = t.long()
        codes = p.get("wte.weight::w8c")
        if codes is None:
            return p["wte.weight"][t]
        # W8A16: wte is quantized per row, one scale shared with the head
        dt = p["ln_f.weight"].dtype
        return codes[t].to(dt) * p["wte.weight::w8s"][t][..., None].to(dt)

    def head(self, p, xf):
        """float32 logits. As the reference, the product runs in the
        compute dtype and is cast to float32 after it; a W8A16 tied head
        applies wte's per-row scales to the output columns."""
        if not self.tied:
            return self.matw(p, "lm_head.weight", xf).float()
        codes = p.get("wte.weight::w8c")
        if codes is None:
            return (xf @ p["wte.weight"].T).float()
        dt = xf.dtype
        return ((xf @ codes.T.to(dt))
                * p["wte.weight::w8s"][None, :].to(dt)).float()

    def matw_row(self, p, name, x):
        """The row-split projections' product (out_proj, fc2): a plain
        `matw` unsharded."""
        return self.matw(p, name, x)

    def block_and_mlp(self, p, i, x, o):
        x = x + self.matw_row(p, f"h.{i}.out_proj.weight", o) \
            + p[f"h.{i}.out_proj.bias"]
        m = self.ln(x, p[f"h.{i}.ln_2.weight"], p[f"h.{i}.ln_2.bias"])
        hdn = F.gelu(self.matw(p, f"h.{i}.fc1.weight", m)
                     + p[f"h.{i}.fc1.bias"], approximate="tanh")
        return x + self.matw_row(p, f"h.{i}.fc2.weight", hdn) \
            + p[f"h.{i}.fc2.bias"]

    def readout(self, params, xf, sp, mode, need_logits):
        """Final layernorm, float32 head logits, the sampled tokens:
        (tokens, logits)."""
        xf = self.ln(xf, params["ln_f.weight"], params["ln_f.bias"])
        logits = self.head(params, xf)
        sampled, penalties = mode
        return _proc.sample_tokens(logits, sp, sampled=sampled,
                                   penalties=penalties), logits


class _ShardedHelpers(_LayerHelpers):
    """The helpers on one rank's slices (`serving_dist.plan.
    shard_decode_params`): H/tp heads, the row-split products summed over
    mp (bias after the sum), the vocab-parallel embedding and head when
    tp divides the vocabulary. `shard` is the rank's context
    (`serving_dist.engine.DecodeShard`): `mesh`, `tp`, `cq` (None or a
    `CollectiveQuant`), `vocab_split`, `v_off`."""

    def __init__(self, spec, shard):
        super().__init__(spec)
        self.shard = shard
        self.H = self.H // shard.tp
        self.Ea = self.H * self.Dh

    def _psum(self, x):
        from ..parallel import comm

        return comm.all_reduce_(x.contiguous(), self.shard.mesh.group("mp"))

    def matw_row(self, p, name, x):
        cq = self.shard.cq
        if cq is None:
            return self._psum(self.matw(p, name, x))
        codes = p.get(name + "::w8c")
        if codes is None:
            return cq.matmul_psum(x, p[name])
        dt = x.dtype
        return cq.matmul_psum(x, codes, cast=dt) * p[name + "::w8s"].to(dt)

    def embed(self, p, t):
        sh = self.shard
        if not sh.vocab_split:
            return super().embed(p, t)
        codes = p.get("wte.weight::w8c")
        dt = p["ln_f.weight"].dtype
        if sh.cq is not None:
            if codes is None:
                return sh.cq.embed_psum(t, p["wte.weight"], sh.v_off, dt=dt)
            return sh.cq.embed_psum(t, codes, sh.v_off,
                                    scales=p["wte.weight::w8s"], dt=dt)
        table = p["wte.weight"] if codes is None else codes
        loc = t.long() - sh.v_off
        ok = (loc >= 0) & (loc < table.shape[0])
        idx = loc.clamp(0, table.shape[0] - 1)
        rows = table[idx]
        if codes is not None:
            rows = rows.to(dt) * p["wte.weight::w8s"][idx][..., None].to(dt)
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        return self._psum(rows)

    def readout(self, params, xf, sp, mode, need_logits):
        sh = self.shard
        if not sh.vocab_split:
            return super().readout(params, xf, sp, mode, need_logits)
        from ..parallel import comm

        xf = self.ln(xf, params["ln_f.weight"], params["ln_f.bias"])
        local = self.head(params, xf)                   # [R, V/tp]
        sampled, penalties = mode
        if sh.cq is not None:
            if not sampled and not penalties and not need_logits:
                return sh.cq.greedy_tokens(local), None
            logits = sh.cq.gather_logits(local)
        else:
            logits = torch.cat(comm.all_gather(local, sh.mesh.group("mp")),
                               dim=-1)
        return _proc.sample_tokens(logits, sp, sampled=sampled,
                                   penalties=penalties), logits


def _rep(t, n):
    """Each row of t repeated n times in place (row-major), by expand:
    `repeat_interleave` may read its repeat count back to the host."""
    return t.unsqueeze(1).expand(t.shape[0], n, *t.shape[1:]) \
        .reshape(t.shape[0] * n, *t.shape[1:])


class PagedDecoder:
    """The (prefill, step, packed_prefill, multistep, packed_verify,
    unified_round) family over the paged KV
    cache for one GPT-2-layout spec. Stateless apart from its spec:
    every call takes the params, the inputs and the cache tensors.

    kv_dtype: None pairs with a dense `PagedKVCache`; "int8" with
    `PagedKVCache(kv_dtype="int8")`. Every call checks the pairing
    first and raises naming the mismatched argument.
    return_logits: the programs also return their float32 logits."""

    def __init__(self, spec, block_size, return_logits=False,
                 kv_dtype=None, shard=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             "(supported: None, 'int8')")
        self.spec = tuple(spec)
        self.block_size = int(block_size)
        self.return_logits = bool(return_logits)
        self.kv_dtype = kv_dtype
        self._kv_quant = kv_dtype == "int8"
        self._shard = shard
        self._hp = (_LayerHelpers(self.spec) if shard is None
                    else _ShardedHelpers(self.spec, shard))
        self._kv_write, self._kv_layer = _kv_io(self._kv_quant)
        self._scale = self.spec[2] ** -0.5
        self._graphs = None

    @property
    def graphs(self):
        """This decoder's CUDA graph cache (`nn.decode_graph.DecodeGraphs`,
        made at first use): `graphs(k, mode, *multistep's arguments)` runs
        `multistep(k, mode)` as one captured graph on the card."""
        if self._graphs is None:
            self._graphs = DecodeGraphs(self)
        return self._graphs

    def _check_kv(self, kc, vc):
        for name, arr in (("kc", kc), ("vc", vc)):
            got = hasattr(arr, "codes")
            if got != self._kv_quant:
                have = "a quantized int8 (QuantizedKV)" if got \
                    else "a dense"
                raise ValueError(
                    f"kv dtype mismatch: PagedDecoder(kv_dtype="
                    f"{self.kv_dtype!r}) was handed {have} cache array "
                    f"for argument '{name}' — build the PagedKVCache "
                    f"and the PagedDecoder with the SAME kv_dtype")

    def _out(self, tok, stopped, kc, vc, counts, logits):
        if self.return_logits:
            return tok, stopped, kc, vc, counts, logits
        return tok, stopped, kc, vc, counts

    def prefill(self, params, ids, lens, tables, kc, vc, sp,
                mode=GREEDY_MODE):
        """ids [B, S0] right-padded prompts; lens [B] their lengths;
        tables [B, M]. Position t of row b is written to its block when
        t < lens[b], else to the trash block. Returns (tok0 [B], stopped
        [B], kc, vc, counts or None[, logits0 [B, V] f32])."""
        self._check_kv(kc, vc)
        with torch.no_grad():
            hp, BS = self._hp, self.block_size
            B, S0 = ids.shape
            M = tables.shape[1]
            dev = ids.device
            t = torch.arange(S0, device=dev)
            valid = t[None, :] < lens[:, None]                 # [B, S0]
            x = hp.embed(params, ids) + params["wpe.weight"][t]
            col = (t // BS).clamp(max=M - 1)
            blk = torch.where(valid, tables[:, col].long(), 0)  # [B, S0]
            off = (t % BS)[None, :].expand(B, S0)
            causal = torch.ones((S0, S0), dtype=torch.bool,
                                device=dev).tril()
            kmask = causal[None, None] & valid[:, None, None, :]
            for i in range(hp.L):
                a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                          params[f"h.{i}.ln_1.bias"])
                q, k, v = hp.qkv_split(params, i, a)       # [B, S0, H, Dh]
                kc = self._kv_write(kc, i, blk, off, k)
                vc = self._kv_write(vc, i, blk, off, v)
                qh, kh, vh = (u.transpose(1, 2) for u in (q, k, v))
                s = (qh @ kh.transpose(-1, -2)).float() * self._scale
                s = torch.where(kmask, s, -1e30)
                w = torch.softmax(s, dim=-1).to(x.dtype)
                o = (w @ vh).transpose(1, 2).reshape(B, S0, hp.Ea)
                x = hp.block_and_mlp(params, i, x, o)
            rows = torch.arange(B, device=dev)
            xf = x[rows, lens.long() - 1]                  # true last token
            tok, logits = hp.readout(params, xf, sp, mode,
                                       self.return_logits)
            ones = torch.ones((B,), dtype=torch.bool, device=dev)
            stopped = _proc.check_stops(tok, sp["stop"], ones)
            counts = None
            if mode[1]:
                counts = _proc.update_counts(sp["counts"], rows, tok, ones)
        return self._out(tok, stopped, kc, vc, counts, logits)

    @torch.no_grad()
    def _step(self, params, tok, pos, active, tables, kc, vc, sp, mode):
        hp, BS = self._hp, self.block_size
        B = tok.shape[0]
        M = tables.shape[1]
        pos = pos.long()
        x = hp.embed(params, tok) + params["wpe.weight"][pos]  # [B, E]
        # the reference's gather clamps an out-of-range column; clamp
        # explicitly (idle slots sit at pos 0 and write the trash block)
        col = (pos // BS).clamp(max=M - 1)
        rows = torch.arange(B, device=tok.device)
        blk = torch.where(active, tables[rows, col].long(), 0)
        off = pos % BS
        ctx = torch.where(active, pos + 1, 1).to(torch.int32)
        for i in range(hp.L):
            a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                      params[f"h.{i}.ln_1.bias"])
            q, k, v = hp.qkv_split(params, i, a)           # [B, H, Dh]
            kc = self._kv_write(kc, i, blk, off, k)
            vc = self._kv_write(vc, i, blk, off, v)
            o = paged_decode_attention(
                q, self._kv_layer(kc, i), self._kv_layer(vc, i), tables,
                ctx, scale=self._scale).reshape(B, hp.Ea)
            x = hp.block_and_mlp(params, i, x, o)
        nxt, logits = hp.readout(params, x, sp, mode, self.return_logits)
        nxt = torch.where(active, nxt, 0)
        stopped = _proc.check_stops(nxt, sp["stop"], active)
        counts = None
        if mode[1]:
            counts = _proc.update_counts(sp["counts"], rows, nxt, active)
        return nxt, stopped, kc, vc, counts, logits

    def step(self, params, tok, pos, active, tables, kc, vc, sp,
             mode=GREEDY_MODE):
        """One decode token per sequence. tok [B] is written at cache
        position pos [B]; attention sees positions [0, pos]. Idle slots
        (active False) write to trash and emit token 0. Returns (tok [B],
        stopped [B], kc, vc, counts or None[, logits [B, V] f32])."""
        self._check_kv(kc, vc)
        return self._out(*self._step(params, tok, pos, active, tables, kc,
                                     vc, sp, mode))

    @torch.no_grad()
    def _trunk(self, params, toks, seg, pos, tables, kc, vc):
        hp, BS = self._hp, self.block_size
        T = toks.shape[0]
        M = tables.shape[1]
        valid = pos >= 0
        p0 = torch.where(valid, pos, 0).long()
        x = hp.embed(params, toks) + params["wpe.weight"][p0]  # [T, E]
        # pad tokens write to the trash block; their attention output is
        # finite garbage no sample index reads
        col = (p0 // BS).clamp(max=M - 1)
        blk = torch.where(valid, tables[seg.long(), col].long(), 0)
        off = p0 % BS
        for i in range(hp.L):
            a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                      params[f"h.{i}.ln_1.bias"])
            q, k, v = hp.qkv_split(params, i, a)           # [T, H, Dh]
            kc = self._kv_write(kc, i, blk, off, k)
            vc = self._kv_write(vc, i, blk, off, v)
            o = ragged_prefill_attention(
                q, self._kv_layer(kc, i), self._kv_layer(vc, i), tables,
                seg, pos, scale=self._scale).reshape(T, hp.Ea)
            x = hp.block_and_mlp(params, i, x, o)
        return x, kc, vc

    @torch.no_grad()
    def _sp_trunk(self, params, toks, seg, pos, tables, kc, vc):
        """The packed trunk sequence-parallel over the shard's sp ranks:
        this rank embeds and projects its T/sp rows (T a multiple of sp);
        K/V are all-gathered over sp and the whole stream written to the
        rank's pool replica, then K1 runs on the rank's rows with the
        global tables (or the ring/ulysses attention takes the layer).
        Returns the whole hidden stream [T, E] (all-gathered over sp)."""
        from ..parallel import comm

        sh, hp, BS = self._shard, self._hp, self.block_size
        T = toks.shape[0]
        M = tables.shape[1]
        n, j = sh.mesh.size("sp"), sh.mesh.axis_index("sp")
        if T % n:
            raise ValueError(f"sp trunk: stream length {T} is not a "
                             f"multiple of sp={n}")
        tl = T // n
        rows = slice(j * tl, (j + 1) * tl)
        group = sh.mesh.group("sp")
        valid = pos >= 0
        p0 = torch.where(valid, pos, 0).long()
        col = (p0 // BS).clamp(max=M - 1)
        blk = torch.where(valid, tables[seg.long(), col].long(), 0)
        off = p0 % BS
        x = hp.embed(params, toks[rows]) + params["wpe.weight"][p0[rows]]
        starts = None
        if sh.sp_attn is not None:
            from ..serving_dist.sp_attention import segment_starts

            starts = segment_starts(seg, pos, tables.shape[0])
        for i in range(hp.L):
            a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                      params[f"h.{i}.ln_1.bias"])
            q, k, v = hp.qkv_split(params, i, a)          # [T/sp, H, Dh]
            if sh.sp_attn is not None:
                o = sh.sp_attn(q, k, v, self._kv_layer(kc, i),
                               self._kv_layer(vc, i), tables, seg, pos,
                               starts)
            else:
                kc = self._kv_write(kc, i, blk, off,
                                    torch.cat(comm.all_gather(k, group)))
                vc = self._kv_write(vc, i, blk, off,
                                    torch.cat(comm.all_gather(v, group)))
                o = ragged_prefill_attention(
                    q, self._kv_layer(kc, i), self._kv_layer(vc, i), tables,
                    seg[rows], pos[rows], scale=self._scale)
            x = hp.block_and_mlp(params, i, x, o.reshape(tl, hp.Ea))
        return torch.cat(comm.all_gather(x, group)), kc, vc

    def packed_prefill(self, params, toks, seg, pos, tables, sample_idx,
                       kc, vc, sp, mode=GREEDY_MODE):
        """toks [T] packed token stream; seg [T] slot row per token; pos
        [T] absolute cache position (-1 = packing pad); tables [B, M];
        sample_idx [B] packed index of each row's last prompt token in
        this chunk. Returns (tok [B], stopped [B], kc, vc, counts or
        None[, logits [B, V] f32]); the caller reads only rows whose
        prompt completed in this chunk (in penalty mode only those rows,
        `sp["row_done"]`, add to the counts of their slots,
        `sp["crows"]`)."""
        self._check_kv(kc, vc)
        trunk = self._trunk
        if self._shard is not None and self._shard.mesh.size("sp") > 1:
            trunk = self._sp_trunk
        with torch.no_grad():
            x, kc, vc = trunk(params, toks, seg, pos, tables, kc, vc)
            tok, logits = self._hp.readout(params, x[sample_idx.long()],
                                           sp, mode, self.return_logits)
            ones = torch.ones(sample_idx.shape[0], dtype=torch.bool,
                              device=toks.device)
            stopped = _proc.check_stops(tok, sp["stop"], ones)
            counts = None
            if mode[1]:
                counts = _proc.update_counts(sp["counts"], sp["crows"], tok,
                                             sp["row_done"])
        return self._out(tok, stopped, kc, vc, counts, logits)

    @torch.no_grad()
    def _verify_trunk(self, params, toks, seg, pos, tables, kc, vc):
        """The packed trunk on the verify plan's pinned layout: T = P * W,
        one W-token region per plan row, attention through
        `verify_window_attention` (K1 on the flattened stream on the
        card; the per-row [P, W] plain version on the CPU)."""
        hp, BS = self._hp, self.block_size
        T = toks.shape[0]
        P, M = tables.shape
        W = T // P
        valid = pos >= 0
        p0 = torch.where(valid, pos, 0).long()
        x = hp.embed(params, toks) + params["wpe.weight"][p0]  # [T, E]
        col = (p0 // BS).clamp(max=M - 1)
        blk = torch.where(valid, tables[seg.long(), col].long(), 0)
        off = p0 % BS
        pos2 = pos.reshape(P, W)
        for i in range(hp.L):
            a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                      params[f"h.{i}.ln_1.bias"])
            q, k, v = hp.qkv_split(params, i, a)           # [T, H, Dh]
            kc = self._kv_write(kc, i, blk, off, k)
            vc = self._kv_write(vc, i, blk, off, v)
            o = verify_window_attention(
                q.reshape(P, W, hp.H, hp.Dh), self._kv_layer(kc, i),
                self._kv_layer(vc, i), tables, pos2,
                scale=self._scale).reshape(T, hp.Ea)
            x = hp.block_and_mlp(params, i, x, o)
        return x, kc, vc

    def _verify_readout(self, params, x, toks, sample_idx, dlen, sp, mode,
                        base):
        """The verify readout shared by `packed_verify` and
        `unified_round`: sample every row's K1 positions (position j at
        PRNG step base + j; in penalty mode its counts include drafts
        1..j), the per-position stop flags, the accepted draft counts
        and the emitted positions (the accepted prefix plus the bonus
        token, cut after the first stop; none on rows with dlen < 0).
        Returns (vtok [P, K1], accepted [P], stopped [P, K1], counts or
        None, emit [P, K1], logits [P * K1, V])."""
        sampled, penalties = mode
        P, K1 = sample_idx.shape
        si = sample_idx.long()
        fed = toks[si]                                     # [P, K1]
        j = torch.arange(K1, device=toks.device)[None, :]
        draft_valid = (j >= 1) & (j <= dlen[:, None])       # real drafts
        row_valid = dlen >= 0
        # the per-row columns as per-position rows, row-major [P, K1]
        spf = {"stop": _rep(sp["stop"], K1)}
        if sampled:
            for col in ("temperature", "top_k", "top_p", "min_p", "seeds",
                        "sample"):
                spf[col] = _rep(sp[col], K1)
            spf["steps"] = (base[:, None] + j).reshape(-1).to(torch.int32)
        if penalties:
            for col in ("rep", "pres", "freq"):
                spf[col] = _rep(sp[col], K1)
            # position j's text so far includes drafts 1..j: they ARE
            # the emitted tokens whenever position j's verdict matters
            bc = sp["counts"][sp["crows"].long()]          # [P, V]
            V = bc.shape[-1]
            oh = torch.zeros((P, K1, V), dtype=torch.int32,
                             device=toks.device).scatter_(
                2, fed.long()[..., None],
                draft_valid[..., None].to(torch.int32))
            spf["counts"] = (bc[:, None] + torch.cumsum(oh, dim=1,
                                                        dtype=torch.int32)
                             ).reshape(P * K1, V)
        tok, logits = self._hp.readout(params, x[si.reshape(-1)], spf, mode,
                                       self.return_logits)
        vtok = tok.reshape(P, K1)
        stopped = _proc.check_stops(tok, spf["stop"],
                                    _rep(row_valid, K1)).reshape(P, K1)
        # draft j is accepted iff it matches the target's token at the
        # position before it and every earlier draft was accepted
        matches = (fed[:, 1:] == vtok[:, :-1]) & draft_valid[:, 1:]
        accepted = torch.cumprod(matches.to(torch.int32), dim=1) \
            .sum(dim=1).to(torch.int32)
        sint = stopped.to(torch.int32)
        stop_before = torch.cumsum(sint, dim=1) - sint
        emit = (j <= accepted[:, None]) & (stop_before == 0) \
            & row_valid[:, None]
        counts = None
        if penalties:
            # count exactly the emitted tokens (a later host-side stop,
            # a stop string or the budget, ends the request, and its row
            # is reset at the next admission)
            counts = _proc.update_counts(sp["counts"], _rep(sp["crows"], K1),
                                         tok, emit.reshape(-1))
        return vtok, accepted, stopped, counts, emit, logits

    def packed_verify(self, params, toks, seg, pos, tables, sample_idx,
                      dlen, kc, vc, sp, mode=GREEDY_MODE):
        """Speculative verification over a pinned verify plan
        (`spec_decode.build_verify_plan`): toks/seg/pos the packed [P * W]
        stream holding each row's last emitted token and its drafts (their
        K/V written at pos .. pos + k; the caller rolls rejected positions
        back with `PagedKVCache.truncate_seq`); tables [P, M]; sample_idx
        [P, K1] the packed index of each row's verify position j (clamped
        to the region's end past its drafts); dlen [P] the draft count (0
        = a real row without drafts: its one position is a decode step;
        -1 = a padding row); sp from `SlotParamStore.verify_args` (base
        PRNG steps in sp["steps"]). Returns (vtok [P, K1] the target's
        tokens, accepted [P], stopped [P, K1], kc, vc, counts or None[,
        logits [P, K1, V] f32]). Row r emits vtok[r, :accepted + 1], cut
        after the first stopped position: what accepted + 1 sequential
        decode steps would have emitted."""
        self._check_kv(kc, vc)
        with torch.no_grad():
            x, kc, vc = self._verify_trunk(params, toks, seg, pos, tables,
                                           kc, vc)
            base = sp.get("steps")
            vtok, accepted, stopped, counts, _emit, logits = \
                self._verify_readout(params, x, toks, sample_idx, dlen, sp,
                                     mode, base)
        out = (vtok, accepted, stopped, kc, vc, counts)
        if self.return_logits:
            return out + (logits.reshape(*vtok.shape, -1),)
        return out

    def unified_round(self, params, toks, seg, pos, tables, sample_idx,
                      dlen, row_slot, carry_map, pos_map, steps_map,
                      carry_tok, carry_pos, carry_steps, kc, vc, sp,
                      mode=GREEDY_MODE, window=False):
        """One scheduler round in one dispatch: prefill chunk rows, decode
        rows and verify regions of one packed stream, with
        `packed_verify`'s readout over sample_idx [P, K1] and dlen [P] (a
        decode row is dlen 0; a prefill row completing its prompt is dlen
        0 at its base step; a still-feeding prefill row or a pad row is
        -1 and emits nothing while its K/V writes land).

        The device carry (async rounds): carry_tok / carry_pos /
        carry_steps [S] are slot-indexed outputs of the previous round;
        carry_map / pos_map [T] name the slot whose carried token /
        write position feeds a stream position (-1 = the host's toks /
        pos; a carried pos holds the offset within the region, added to
        the slot's carried position), steps_map [P] likewise a row's base
        PRNG step. row_slot [P] names each row's slot. A synchronous round
        passes every map as -1 and zero carries.

        Returns (vtok [P, K1], accepted [P], stopped [P, K1], kc, vc,
        counts or None, carry_tok, carry_pos, carry_steps[, logits [P,
        K1, V] f32]): the new carry holds, for every emitting row's slot,
        the last token emitted this round, the next write position and
        the next PRNG step; other slots pass through. window=True: every
        row is one pinned W-token region (T = P * W) over the verify
        trunk; window=False: the packed trunk."""
        self._check_kv(kc, vc)
        with torch.no_grad():
            sampled, _penalties = mode
            P, K1 = sample_idx.shape
            S = carry_tok.shape[0]
            # resolve the carried inputs (sync rounds: every map is -1)
            cm = carry_map.long().clamp(0, S - 1)
            toks_eff = torch.where(carry_map >= 0, carry_tok[cm], toks)
            pm = pos_map.long().clamp(0, S - 1)
            pos_eff = torch.where(pos_map >= 0, carry_pos[pm] + pos, pos)
            if window:
                x, kc, vc = self._verify_trunk(params, toks_eff, seg,
                                               pos_eff, tables, kc, vc)
            else:  # the packed trunk: its attention is the unified
                # stream's (`ops.unified_stream_attention` is this op)
                x, kc, vc = self._trunk(params, toks_eff, seg, pos_eff,
                                        tables, kc, vc)
            if sampled:
                sm = steps_map.long().clamp(0, S - 1)
                base = torch.where(steps_map >= 0, carry_steps[sm],
                                   sp["steps"])
            else:
                base = torch.zeros((P,), dtype=torch.int32,
                                   device=toks.device)
            vtok, accepted, stopped, counts, emit, logits = \
                self._verify_readout(params, x, toks_eff, sample_idx, dlen,
                                     sp, mode, base)
            # the next round's carry, per emitting row's slot: its last
            # emitted token, next write position and next PRNG step.
            # Rows that emit nothing and slots without a row pass
            # through: their index is S, a spare entry cut off after
            emit_n = emit.sum(dim=1)
            rows = torch.arange(P, device=toks.device)
            last = vtok[rows, (emit_n - 1).clamp(min=0)]
            p0 = pos_eff[sample_idx[:, 0].long()]
            upd = (dlen >= 0) & (row_slot >= 0)
            si = torch.where(upd, row_slot.long().clamp(0, S - 1), S)

            def scatter(carry, val):
                ext = torch.cat([carry, carry.new_zeros(1)])
                ext[si] = val.to(carry.dtype)
                return ext[:S]

            carry_tok = scatter(carry_tok, last)
            carry_pos = scatter(carry_pos, p0 + emit_n)
            carry_steps = scatter(carry_steps, base + emit_n)
        out = (vtok, accepted, stopped, kc, vc, counts, carry_tok,
               carry_pos, carry_steps)
        if self.return_logits:
            return out + (logits.reshape(P, K1, -1),)
        return out

    def multistep(self, n_steps, mode=GREEDY_MODE):
        """`n_steps` decode tokens per call: returns a function with
        `step`'s arguments (but `mode`) that yields (toks [n, B], stopped
        [n, B], kc, vc, counts or None). Each step feeds the previous
        step's tokens at pos+1, samples at PRNG step `sp["steps"] + j`
        and reads the counts the step before it left, so n steps here
        draw the same streams as n calls of `step`; the caller discards
        tokens after a stop."""
        n = int(n_steps)
        sampled, penalties = mode

        def multi(params, tok, pos, active, tables, kc, vc, sp):
            self._check_kv(kc, vc)
            toks, stops = [], []
            counts = sp.get("counts")
            for j in range(n):
                spj = dict(sp)
                if sampled:
                    spj["steps"] = sp["steps"] + j
                if penalties:
                    spj["counts"] = counts
                tok, stopped, kc, vc, cj, _lg = self._step(
                    params, tok, pos, active, tables, kc, vc, spj, mode)
                if penalties:
                    counts = cj
                toks.append(tok)
                stops.append(stopped)
                pos = pos + 1
            return torch.stack(toks), torch.stack(stops), kc, vc, counts

        return multi

    @classmethod
    def for_config(cls, cfg, block_size, **kw):
        """Build from a GPT2Config-like object."""
        return cls(config_spec(cfg), block_size, **kw)


def config_spec(cfg):
    """The spec (L, H, Dh, E, eps, tied) of a GPT2Config-like object."""
    return (cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
            cfg.hidden_size, cfg.layer_norm_epsilon, cfg.tie_embeddings)


__all__ = ["PagedDecoder", "config_spec"]
