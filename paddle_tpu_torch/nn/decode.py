"""The paged decode engine: GPT-2-layout decoder programs over the
block-pool KV cache (`inference/kv_cache.py`).

The port of `paddle_tpu.nn.decode`'s serving programs:

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
    dispatch, as the reference's jitted scan is one device program.

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

Left out: the non-packed `prefill` program, speculative verify, the
unified/async round and every sharding argument.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import paged_decode_attention, ragged_prefill_attention
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
        q, k, v = torch.split(qkv, self.E, dim=-1)
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

    def block_and_mlp(self, p, i, x, o):
        x = x + self.matw(p, f"h.{i}.out_proj.weight", o) \
            + p[f"h.{i}.out_proj.bias"]
        m = self.ln(x, p[f"h.{i}.ln_2.weight"], p[f"h.{i}.ln_2.bias"])
        hdn = F.gelu(self.matw(p, f"h.{i}.fc1.weight", m)
                     + p[f"h.{i}.fc1.bias"], approximate="tanh")
        return x + self.matw(p, f"h.{i}.fc2.weight", hdn) \
            + p[f"h.{i}.fc2.bias"]


def _readout(hp, params, xf, sp, mode):
    """Final layernorm, float32 head logits, the sampled tokens."""
    xf = hp.ln(xf, params["ln_f.weight"], params["ln_f.bias"])
    logits = hp.head(params, xf)
    sampled, penalties = mode
    return _proc.sample_tokens(logits, sp, sampled=sampled,
                               penalties=penalties), logits


class PagedDecoder:
    """The (step, packed_prefill, multistep) family over the paged KV
    cache for one GPT-2-layout spec. Stateless apart from its spec:
    every call takes the params, the inputs and the cache tensors.

    kv_dtype: None pairs with a dense `PagedKVCache`; "int8" with
    `PagedKVCache(kv_dtype="int8")`. Every call checks the pairing
    first and raises naming the mismatched argument.
    return_logits: the programs also return their float32 logits."""

    def __init__(self, spec, block_size, return_logits=False,
                 kv_dtype=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             "(supported: None, 'int8')")
        self.spec = tuple(spec)
        self.block_size = int(block_size)
        self.return_logits = bool(return_logits)
        self.kv_dtype = kv_dtype
        self._kv_quant = kv_dtype == "int8"
        self._hp = _LayerHelpers(self.spec)
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
                ctx, scale=self._scale).reshape(B, hp.E)
            x = hp.block_and_mlp(params, i, x, o)
        nxt, logits = _readout(hp, params, x, sp, mode)
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
                seg, pos, scale=self._scale).reshape(T, hp.E)
            x = hp.block_and_mlp(params, i, x, o)
        return x, kc, vc

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
        with torch.no_grad():
            x, kc, vc = self._trunk(params, toks, seg, pos, tables, kc, vc)
            tok, logits = _readout(self._hp, params, x[sample_idx.long()],
                                   sp, mode)
            ones = torch.ones(sample_idx.shape[0], dtype=torch.bool,
                              device=toks.device)
            stopped = _proc.check_stops(tok, sp["stop"], ones)
            counts = None
            if mode[1]:
                counts = _proc.update_counts(sp["counts"], sp["crows"], tok,
                                             sp["row_done"])
        return self._out(tok, stopped, kc, vc, counts, logits)

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
        spec = (cfg.num_layers, cfg.num_heads,
                cfg.hidden_size // cfg.num_heads, cfg.hidden_size,
                cfg.layer_norm_epsilon, cfg.tie_embeddings)
        return cls(spec, block_size, **kw)


__all__ = ["PagedDecoder"]
