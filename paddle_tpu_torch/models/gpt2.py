"""GPT-2 in the reference's flat parameter layout: the weights, and the
training path.

The serving path reads a GPT-2-layout decoder as a FLAT dict of named
tensors — the names `paddle_tpu`'s `GPT2.functional_state()` produces
("wte.weight", "h.{i}.qkv_proj.weight", ...), with every projection
stored `[in, out]` and applied as `x @ W` (the decode programs of
`nn/decode.py`). `GPT2` here is an `nn.Module` whose `named_parameters()`
are exactly those names and layouts, so `flat_params()` is the dict the
decoder consumes and `from_reference_params` is a name-for-name copy of
the reference's numpy weights (the bridge the parity tests use).
`GPT2.quantize_weights` packs that dict for W8A16 serving as the
reference does (int8 codes `name::w8c`, scales `name::w8s`), and
`quantized_params_from_reference` carries the reference's packed dict
across.

Offline generation is `GPT2.generate`, the reference's: the dense
fixed-cache program (`models/gpt2_decode.py`; one CUDA graph replay on
the card) or the paged engine (`kv_cache="paged"`, `nn/decode.py`'s
`prefill` and `step`, K2 on the card). `export_generator` writes that
dense program as the port's deployment artifact, which `jit.load` runs
with no model class.

The training path is a set of pure functions of that dict, as the
reference's `build_train_step` re-binds its params per call:
`hidden_states` (pre-LN blocks, fused QKV split as [3, B, H, S, D],
causal attention through `ops.scaled_dot_product_attention` — the flash
kernels K4/K6 with K9, or K7/K8 past the reference's length switch, on
the card; with an additive [B or 1, 1, 1, S] `attn_mask` (a padded
batch) their per-key-bias variants; with attention dropout the dense
path, as the reference — tanh GELU, final layer norm), `logits`
(the tied head as one rank-2 product `x2 @ wte.T`) and `lm_loss` (mean
cross-entropy; the reference's vocab-chunked loss under
`PADDLE_TPU_CHUNKED_CE=<n>`, `ops/chunked_xent.py`).
`build_train_step(cfg)` returns `loss_fn(params, batch)` and
`init_params()`; `GPT2.forward`/`GPT2.loss` run the same functions on
the module's own parameters. `position_ids` ([S] or [B, S]; default
0..S-1) and `attn_mask` are the reference's `GPT2.forward` arguments;
`lm_loss`, `GPT2.loss` and `build_train_step` take no mask, as the
reference's do (a padded batch composes `logits(..., attn_mask=)` with
`ops.loss.cross_entropy`, pad labels -100). Embedding, residual and
attention dropout draw from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import scaled_dot_product_attention
from ..ops.chunked_xent import chunked_softmax_xent
from ..ops.loss import cross_entropy


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 1024
    intermediate_size: int = None  # defaults to 4*hidden
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def medium(cls):
        return cls(hidden_size=1024, num_layers=24, num_heads=16)

    @classmethod
    def large(cls):
        return cls(hidden_size=1280, num_layers=36, num_heads=20)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_layers=2,
                   num_heads=4, max_position=256)


def param_shapes(cfg):
    """{flat name: shape} of a GPT-2-layout decoder — the reference's
    `functional_state()` keys, projections `[in, out]`."""
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"wte.weight": (V, E), "wpe.weight": (cfg.max_position, E)}
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        shapes.update({
            p + "ln_1.weight": (E,), p + "ln_1.bias": (E,),
            p + "qkv_proj.weight": (E, 3 * E), p + "qkv_proj.bias": (3 * E,),
            p + "out_proj.weight": (E, E), p + "out_proj.bias": (E,),
            p + "ln_2.weight": (E,), p + "ln_2.bias": (E,),
            p + "fc1.weight": (E, F), p + "fc1.bias": (F,),
            p + "fc2.weight": (F, E), p + "fc2.bias": (E,),
        })
    shapes.update({"ln_f.weight": (E,), "ln_f.bias": (E,)})
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (E, V)
    return shapes


class _Leaf(nn.Module):
    """A module holding named parameters and nothing else (so the
    parameter paths spell the reference's flat names)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


class _Block(nn.Module):
    def __init__(self, leaves):
        super().__init__()
        for name, leaf in leaves.items():
            setattr(self, name, leaf)


class GPT2(nn.Module):
    """GPT-2-layout decoder parameters, initialized from a seeded
    `torch.Generator`: embeddings normal(0, 0.02) (as the reference),
    projections Xavier-uniform (the reference Linear's default init
    scale), biases zero, layer norms (1, 0).

    device: None -> CUDA (raises when absent); pass "cpu" for the plain
    path. dtype: parameter dtype (float32 default; bfloat16 for
    serving). init=False leaves the parameters unset, for callers that
    load weights into them (`from_reference_params`)."""

    def __init__(self, cfg: GPT2Config = None, *, seed=0,
                 dtype=torch.float32, device=None, init=True):
        super().__init__()
        self.cfg = cfg or GPT2Config()
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        shapes = param_shapes(self.cfg)

        def make(name):
            shape = shapes[name]
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            if not init:
                return t.to(dtype)
            leaf = name.rsplit(".", 1)
            if name in ("wte.weight", "wpe.weight"):
                t.normal_(0.0, 0.02, generator=g)
            elif leaf[0].endswith(("ln_1", "ln_2", "ln_f")):
                t.fill_(1.0 if leaf[1] == "weight" else 0.0)
            elif leaf[1] == "bias":
                t.zero_()
            else:  # projection [in, out]
                bound = math.sqrt(6.0 / (shape[0] + shape[1]))
                t.uniform_(-bound, bound, generator=g)
            return t.to(dtype)

        def leaf(prefix, *names):
            return _Leaf(**{n: make(f"{prefix}.{n}") for n in names})

        self.wte = leaf("wte", "weight")
        self.wpe = leaf("wpe", "weight")
        blocks = []
        for i in range(self.cfg.num_layers):
            p = f"h.{i}"
            blocks.append(_Block({
                "ln_1": leaf(p + ".ln_1", "weight", "bias"),
                "qkv_proj": leaf(p + ".qkv_proj", "weight", "bias"),
                "out_proj": leaf(p + ".out_proj", "weight", "bias"),
                "ln_2": leaf(p + ".ln_2", "weight", "bias"),
                "fc1": leaf(p + ".fc1", "weight", "bias"),
                "fc2": leaf(p + ".fc2", "weight", "bias"),
            }))
        self.h = nn.ModuleList(blocks)
        self.ln_f = leaf("ln_f", "weight", "bias")
        if not self.cfg.tie_embeddings:
            self.lm_head = leaf("lm_head", "weight")

    def flat_params(self):
        """{flat name: tensor} — the dict the decode programs read
        (same names and layouts as the reference's functional_state),
        detached from autograd."""
        return {n: p.detach() for n, p in self.named_parameters()}

    def quantize_weights(self, params=None):
        """Weight-only int8 (W8A16) packing of the decode path's large 2-D
        weights, the reference's `GPT2.quantize_weights`: a NEW flat dict
        where each quantized weight `name` is replaced by `name::w8c`
        (int8 codes) and `name::w8s` (scales in the weight's dtype); every
        other entry passes through. `params` defaults to `flat_params()`.
        The serving engine calls it once, at construction."""
        if params is None:
            params = self.flat_params()
        return quantize_decode_weights_int8(params, self.cfg)

    def _decode_params(self, weight_quant):
        """The flat params a generate call decodes with. W8A16 packs them
        anew on every call, as the reference, and copies the codes and
        scales into buffers kept from the previous call (same names,
        shapes, dtypes and device): the dense program's graph is keyed
        by the params' addresses, so a repeated call replays it."""
        params = self.flat_params()
        if weight_quant is None:
            return params
        if weight_quant != "int8":
            raise ValueError(f"unknown weight_quant {weight_quant!r} "
                             "(supported: 'int8')")
        packed = quantize_decode_weights_int8(params, self.cfg)
        fresh = {k: v for k, v in packed.items() if "::w8" in k}
        held = getattr(self, "_w8_buffers", None)
        if held is None or any(
                k not in held or held[k].shape != v.shape
                or held[k].dtype != v.dtype or held[k].device != v.device
                for k, v in fresh.items()):
            self._w8_buffers = fresh
        else:
            for k, v in fresh.items():
                held[k].copy_(v)
        return {**{k: v for k, v in packed.items() if "::w8" not in k},
                **self._w8_buffers}

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens, temperature=0.0,
                 eos_token_id=None, seed=0, top_k=0, top_p=1.0,
                 pad_token_id=None, weight_quant=None, kv_quant=None,
                 kv_cache="dense", prompt_lens=None, block_size=16,
                 sampling=None):
        """Autoregressive decoding with a KV cache, as the reference's
        `GPT2.generate` (`paddle_tpu/models/gpt2.py:176-309`), on the
        model's device. Returns [B, S0 + max_new_tokens] int32 tokens
        there (the prompt when max_new_tokens is 0).

        kv_cache="dense": the fixed-cache program of
        `models/gpt2_decode.py` (one CUDA graph replay on the card).
        Batched prompts of different lengths are LEFT-padded with
        pad_token_id; temperature 0 is greedy, > 0 samples (top_k,
        top_p) from one PRNG stream `seed`.

        kv_cache="paged": the paged engine (`nn.decode.PagedDecoder`)
        over a `PagedKVCache` of block_size: RIGHT-padded prompts with
        per-row `prompt_lens`, the full per-slot sampling pipeline
        (`sampling`, or temperature/top_k/top_p/seed, applied to every
        row; row r draws stream seed + r), kv_quant="int8" an int8 pool.
        Each step is one graph replay of `PagedDecoder.graphs` (k = 1) on
        the card.

        weight_quant="int8": W8A16 weights (`quantize_weights`), either
        path. sampling: a `SamplingParams` for every row; on the dense
        path only its program-level subset (temperature, top_p, top_k,
        seed, one stop id)."""
        from ..sampling import SamplingParams

        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, "
                            f"got {type(sampling).__name__}")
        if sampling is not None and sampling.stop_strings:
            raise ValueError("stop_strings need a detokenizer — serve "
                             "via PagedGenerationServer(detokenize=...)")
        if sampling is not None and sampling.max_new_tokens is not None:
            max_new_tokens = sampling.max_new_tokens
        dev = self.wte.weight.device
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids,
                                                       torch.Tensor)
                         else input_ids)
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if max_new_tokens == 0:
            return torch.from_numpy(ids.astype(np.int32)).to(dev)
        if kv_cache not in ("dense", "paged"):
            raise ValueError(f"unknown kv_cache {kv_cache!r} "
                             "(supported: 'dense', 'paged')")
        if kv_cache == "paged":
            if kv_quant not in (None, "int8"):
                raise ValueError(f"unknown kv_quant {kv_quant!r} "
                                 "(supported: 'int8')")
            if sampling is None:
                sampling = SamplingParams(
                    temperature=float(temperature), top_k=int(top_k),
                    top_p=float(top_p), seed=int(seed))
            return self._generate_paged(
                ids, max_new_tokens, eos_token_id, seed, pad_token_id,
                prompt_lens, block_size, weight_quant, sampling, kv_quant)
        if sampling is not None:
            # the dense program's subset: per-slot fields are the paged
            # path's (the dense decode is one program)
            for f in ("min_p", "repetition_penalty", "presence_penalty",
                      "frequency_penalty"):
                default = 1.0 if f == "repetition_penalty" else 0.0
                if getattr(sampling, f) != default:
                    raise ValueError(
                        f"kv_cache='dense' does not support "
                        f"SamplingParams.{f}={getattr(sampling, f)!r}; "
                        f"use kv_cache='paged'")
            if len(sampling.stop_token_ids) > 1:
                raise ValueError(
                    "kv_cache='dense' supports at most one stop token "
                    f"id (the eos), got {sampling.stop_token_ids!r}")
            temperature = sampling.temperature
            top_k = sampling.top_k
            top_p = sampling.top_p
            if sampling.seed is not None:
                seed = sampling.seed
            if sampling.stop_token_ids:
                eos_token_id = sampling.stop_token_ids[0]
        if prompt_lens is not None:
            raise ValueError("prompt_lens is only meaningful with "
                             "kv_cache='paged' (the dense path derives "
                             "lengths from LEFT padding)")
        if ids.shape[1] + max_new_tokens > self.cfg.max_position:
            raise ValueError(
                f"prompt ({ids.shape[1]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_position "
                f"({self.cfg.max_position})")
        if pad_token_id is not None:
            # batched prompts of different lengths must be LEFT-padded:
            # the decode reads each prompt's last token at position -1
            valid = ids != pad_token_id
            if not valid.any(axis=1).all():
                raise ValueError("a prompt row is entirely padding")
            if (np.diff(valid.astype(np.int8), axis=1) < 0).any():
                raise ValueError(
                    "prompts must be LEFT-padded (pad tokens only at the "
                    "start of each row)")
        params = self._decode_params(weight_quant)
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             "(supported: 'int8')")
        from .gpt2_decode import decode_program

        prog = decode_program(self.cfg, max_new_tokens, top_k,
                              float(top_p) < 1.0, kv_quant == "int8")
        return prog(params, ids, int(seed) & 0xFFFFFFFF, float(temperature),
                    -1 if eos_token_id is None else int(eos_token_id),
                    float(top_p),
                    -1 if pad_token_id is None else int(pad_token_id))

    def _generate_paged(self, ids, max_new, eos_token_id, seed,
                        pad_token_id, prompt_lens, block_size,
                        weight_quant, sampling, kv_quant=None):
        """The paged path of `generate` (the reference's
        `_generate_paged`): RIGHT-padded prompts with per-row lengths,
        the whole horizon reserved per row, one padded prefill, then a
        step loop over `PagedDecoder` with every row's sampling state in
        a `SlotParamStore` (row r: stream seed + r). Rows that stopped
        keep emitting the stop fill (eos, else the fill); each output
        row is [prompt, generated, fill], the fill being pad_token_id,
        else eos, else 0. The loop reads nothing back to the host until
        the end."""
        from ..inference.kv_cache import PagedKVCache, blocks_for
        from ..nn.decode import PagedDecoder
        from ..sampling import SlotParamStore
        from ..sampling.buffers import host_to_device

        ids = np.asarray(ids).astype(np.int32)
        B, S0 = ids.shape
        if prompt_lens is None:
            lens = np.full((B,), S0, np.int32)
        else:
            lens = np.asarray(prompt_lens).astype(np.int32).reshape(-1)
            if lens.shape[0] != B:
                raise ValueError("prompt_lens must have one entry per row")
            if (lens < 1).any() or (lens > S0).any():
                raise ValueError(f"prompt_lens must be in [1, {S0}]")
        if S0 > self.cfg.max_position or \
                int(lens.max()) + max_new > self.cfg.max_position:
            raise ValueError(
                f"prompt ({int(lens.max())}) + max_new_tokens ({max_new}) "
                f"exceeds max_position ({self.cfg.max_position})")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        params = self._decode_params(weight_quant)
        dev = params["ln_f.weight"].device
        dt = params["ln_f.weight"].dtype
        cfg = self.cfg
        bs = int(block_size)
        m_width = blocks_for(max(S0, int(lens.max()) + max_new), bs)
        total_blocks = sum(blocks_for(int(n) + max_new, bs) for n in lens)
        cache = PagedKVCache(cfg.num_layers, cfg.num_heads,
                             cfg.hidden_size // cfg.num_heads,
                             block_size=bs, num_blocks=total_blocks + 1,
                             dtype=dt, kv_dtype=kv_quant, device=dev)
        for b in range(B):  # offline batch: reserve the full horizon
            cache.allocate(b, int(lens[b]) + max_new)
        tables = host_to_device(cache.table_array(range(B), m_width), dev)
        dec = PagedDecoder.for_config(cfg, bs, kv_dtype=kv_quant)
        store = SlotParamStore(B, cfg.vocab_size, dev)
        base_seed = sampling.seed if sampling.seed is not None \
            else int(seed)
        for b in range(B):
            store.set_slot(b, sampling, base_seed + b, eos=eos,
                           prompt_ids=ids[b, :int(lens[b])])
        fill = pad_token_id if pad_token_id is not None \
            else (eos if eos >= 0 else 0)
        stop_fill = eos if eos >= 0 else fill
        lens_t = host_to_device(lens, dev)
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        sp, mode = store.step_args(np.zeros((B,), np.int32))
        tok, done, kc, vc, counts = dec.prefill(
            params, host_to_device(ids, dev), lens_t, tables,
            cache.k_blocks, cache.v_blocks, sp, mode)
        store.swap_counts(counts)
        out_toks = [tok]
        pos = lens_t
        for step in range(1, max_new):
            sp, mode = store.step_args(np.full((B,), step, np.int32))
            args = (params, out_toks[-1], pos, active, tables, kc, vc, sp)
            if dev.type == "cuda":  # one graph replay a step
                nxt, stopped, kc, vc, counts = dec.graphs(1, mode, *args)
                nxt, stopped = nxt[0], stopped[0]
            else:
                nxt, stopped, kc, vc, counts = dec.step(*args, mode)
            # a graph's outputs belong to its next replay: these are new
            store.swap_counts(counts)
            # the dense path's semantics: rows that hit eos (or a stop
            # token) keep emitting the stop fill
            nxt = torch.where(done, stop_fill, nxt)
            done = done | stopped
            out_toks.append(nxt)
            pos = pos + 1
        gen = torch.stack(out_toks, dim=1).cpu().numpy()  # [B, max_new]
        dec.graphs.clear()  # the replays are read: free graph and pool now
        out = np.full((B, S0 + max_new), fill, np.int32)
        for b in range(B):
            n = int(lens[b])
            out[b, :n] = ids[b, :n]
            out[b, n:n + max_new] = gen[b]
        return torch.from_numpy(out).to(dev)

    def _dropout(self):
        return self.cfg.dropout if self.training else 0.0

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                generator=None):
        """Logits [B, S, V] in the parameters' dtype (arguments as the
        reference's `GPT2.forward`; `generator` draws the dropout)."""
        return logits(dict(self.named_parameters()), self.cfg, input_ids,
                      position_ids=position_ids, attn_mask=attn_mask,
                      dropout=self._dropout(), generator=generator)

    def loss(self, input_ids, labels, generator=None):
        return lm_loss(dict(self.named_parameters()), self.cfg, input_ids,
                       labels, dropout=self._dropout(), generator=generator)


# ---- the training path: pure functions of the flat param dict ------------

def _dropout(x, p, generator):
    """Inverted dropout drawing its mask from `generator` (identity at
    p == 0)."""
    if p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def _linear(x, w, b):
    """x @ w + b for a [in, out] weight, as one GEMM with the bias."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def _block(p, i, x, cfg, dropout, generator, attn_mask=None):
    """One pre-LN decoder block (the reference's `GPT2Block.forward`); the
    mask goes to the attention unchanged."""
    B, S, E = x.shape
    H = cfg.num_heads
    pre = f"h.{i}."
    eps = cfg.layer_norm_epsilon
    a = F.layer_norm(x, (E,), p[pre + "ln_1.weight"], p[pre + "ln_1.bias"],
                     eps)
    qkv = _linear(a, p[pre + "qkv_proj.weight"], p[pre + "qkv_proj.bias"])
    qkv = qkv.reshape(B, S, 3, H, E // H).permute(2, 0, 3, 1, 4)
    o, _ = scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                        attn_mask=attn_mask, is_causal=True,
                                        dropout_p=dropout,
                                        generator=generator)
    o = o.permute(0, 2, 1, 3).reshape(B, S, E)
    x = x + _dropout(_linear(o, p[pre + "out_proj.weight"],
                             p[pre + "out_proj.bias"]), dropout, generator)
    m = F.layer_norm(x, (E,), p[pre + "ln_2.weight"], p[pre + "ln_2.bias"],
                     eps)
    m = F.gelu(_linear(m, p[pre + "fc1.weight"], p[pre + "fc1.bias"]),
               approximate="tanh")
    m = _linear(m, p[pre + "fc2.weight"], p[pre + "fc2.bias"])
    return x + _dropout(m, dropout, generator)


def hidden_states(params, cfg, input_ids, *, position_ids=None,
                  attn_mask=None, dropout=0.0, generator=None):
    """The transformer body up to and including the final layer norm:
    [B, S, E] for input_ids [B, S]; position_ids [S] or [B, S] (default
    0..S-1), attn_mask an additive mask for every layer's attention."""
    if position_ids is None:
        position_ids = torch.arange(input_ids.shape[1],
                                    device=input_ids.device)
    x = F.embedding(input_ids, params["wte.weight"]) \
        + F.embedding(position_ids, params["wpe.weight"])
    x = _dropout(x, dropout, generator)
    for i in range(cfg.num_layers):
        x = _block(params, i, x, cfg, dropout, generator, attn_mask)
    return F.layer_norm(x, (cfg.hidden_size,), params["ln_f.weight"],
                        params["ln_f.bias"], cfg.layer_norm_epsilon)


def logits(params, cfg, input_ids, *, position_ids=None, attn_mask=None,
           dropout=0.0, generator=None):
    """[B, S, V] logits. The head is one rank-2 product over [B*S, E]
    (the reference's layout choice, `models/gpt2.py:122-133`)."""
    B, S = input_ids.shape
    x2 = hidden_states(params, cfg, input_ids, position_ids=position_ids,
                       attn_mask=attn_mask, dropout=dropout,
                       generator=generator).reshape(-1, cfg.hidden_size)
    if cfg.tie_embeddings:
        lg = x2 @ params["wte.weight"].T
    else:
        lg = x2 @ params["lm_head.weight"]
    return lg.reshape(B, S, cfg.vocab_size)


def lm_loss(params, cfg, input_ids, labels, *, dropout=0.0,
            generator=None):
    """Mean next-token cross-entropy (labels of -100 are ignored). With
    `PADDLE_TPU_CHUNKED_CE=<n>` (n > 1) and tied embeddings, the
    reference's switch read at each call (`GPT2.loss`,
    `paddle_tpu/models/gpt2.py:135-150`), the vocab-chunked loss of the
    final hidden states against wte, which never holds the [B*S, V]
    logits."""
    n_chunks = int(os.environ.get("PADDLE_TPU_CHUNKED_CE", "0"))
    if n_chunks > 1 and cfg.tie_embeddings:
        h = hidden_states(params, cfg, input_ids, dropout=dropout,
                          generator=generator)
        return chunked_softmax_xent(h.reshape(-1, cfg.hidden_size),
                                    params["wte.weight"], labels.reshape(-1),
                                    n_chunks)
    lg = logits(params, cfg, input_ids, dropout=dropout, generator=generator)
    return cross_entropy(lg.reshape(-1, cfg.vocab_size), labels.reshape(-1))


def build_train_step(cfg, dtype=torch.float32, device=None):
    """The functional GPT-2 loss, as the reference's `build_train_step`:
    returns (loss_fn(params, batch, generator=None), init_params()).

    `init_params()` gives a fresh {flat name: leaf tensor requiring
    grad} of a `GPT2(cfg, dtype=dtype, device=device)` (seed 0; CUDA
    unless device="cpu"). `loss_fn` runs the training forward (dropout
    `cfg.dropout` from `generator`) on any such dict and batch
    {"input_ids": [B, S], "labels": [B, S]} and returns the scalar loss
    in the params' dtype; mixed precision is the caller's: pass bf16
    copies of float32 masters and cast the loss to float32."""
    model = GPT2(cfg, dtype=dtype, device=device)

    def init_params():
        return {n: p.detach().clone().requires_grad_(True)
                for n, p in model.named_parameters()}

    def loss_fn(params, batch, generator=None):
        return lm_loss(params, cfg, batch["input_ids"], batch["labels"],
                       dropout=cfg.dropout, generator=generator)

    return loss_fn, init_params


def export_generator(model, path_prefix, prompt_len, max_new_tokens,
                     top_k=0, top_p_enabled=False, batch_size=None,
                     weight_quant=None, kv_quant=None):
    """Write the dense decode program as the port's deployment artifact
    (`jit`'s module docstring has the format), the reference's
    `export_generator` (`paddle_tpu/models/gpt2.py:705-786`):

        served = paddle_tpu_torch.jit.load(path_prefix)
        tokens = served(ids, seed, temperature, eos, top_p, pad)

    ids [B, prompt_len] (any B when batch_size is None); the program's
    static configuration (max_new_tokens, top_k, top_p_enabled,
    kv_quant) and the model's config go into the meta, its params (W8A16
    packed when weight_quant="int8") into the npz. Returns the .pdmodel
    path."""
    from .. import jit as jit_mod

    cfg = model.cfg
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1 for an exported "
                         "generator (a 0-token artifact has no decode)")
    if prompt_len + max_new_tokens > cfg.max_position:
        raise ValueError("prompt_len + max_new_tokens exceeds max_position")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r} "
                         "(supported: 'int8')")
    params = model.flat_params()
    if weight_quant == "int8":
        params = model.quantize_weights(params)
    elif weight_quant is not None:
        raise ValueError(f"unknown weight_quant {weight_quant!r} "
                         "(supported: 'int8')")
    meta = {"kind": "gpt2_generator", "format": jit_mod.FORMAT,
            "weight_quant": weight_quant, "kv_quant": kv_quant,
            "prompt_len": int(prompt_len),
            "max_new_tokens": int(max_new_tokens), "top_k": int(top_k),
            "top_p_enabled": bool(top_p_enabled),
            # None = batch-polymorphic (serving layers pick their own B)
            "batch_size": None if batch_size is None else int(batch_size),
            "inputs": ["ids[int32]", "seed[uint32]",
                       "temperature[f32]", "eos[int32]", "top_p[f32]",
                       "pad[int32] (-1 disables left-pad masking)"],
            "config": {k: getattr(cfg, k) for k in jit_mod.CONFIG_FIELDS}}
    return jit_mod.write_artifact(path_prefix, params, meta)


def _w8_weights(cfg):
    """(name, reduction axis) of each weight W8A16 quantizes: wte per
    ROW (its scale serves the embedding gather and the tied head);
    lm_head (untied) and each layer's qkv_proj, out_proj, fc1 and fc2
    per output COLUMN."""
    return ([("wte.weight", 1)]
            + ([] if cfg.tie_embeddings else [("lm_head.weight", 0)])
            + [(f"h.{i}.{part}.weight", 0) for i in range(cfg.num_layers)
               for part in ("qkv_proj", "out_proj", "fc1", "fc2")])


def quantize_decode_weights_int8(params, cfg):
    """Per-channel symmetric int8 of the reference's
    `_quantize_decode_weights_int8`: codes = clip(round(w / s), +-127)
    with s = max(amax, 1e-12) / 127, all in float32 (`torch.round` rounds
    half to even, as `jnp.round`), so the codes equal the reference's bit
    for bit; the weights and axes of `_w8_weights`."""
    out = dict(params)
    for name, axis in _w8_weights(cfg):
        w = out.pop(name)
        wf = w.float()
        amax = wf.abs().amax(dim=axis, keepdim=True)
        scale = amax.clamp_min(1e-12) / 127.0
        out[name + "::w8c"] = torch.round(wf / scale).clamp(
            -127, 127).to(torch.int8)
        out[name + "::w8s"] = scale.squeeze(axis).to(w.dtype)
    return out


def quantized_param_shapes(cfg):
    """{flat name: shape} of W8A16 params: `param_shapes` with each
    quantized weight replaced by its codes (the weight's shape) and its
    scales (one per row of wte, one per output column otherwise)."""
    shapes = param_shapes(cfg)
    for name, axis in _w8_weights(cfg):
        shape = shapes.pop(name)
        shapes[name + "::w8c"] = shape
        shapes[name + "::w8s"] = (shape[1 - axis],)
    return shapes


def _host_tensor(a):
    """numpy -> a CPU tensor of the same dtype (a bf16 array of
    ml_dtypes through float32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def quantized_params_from_reference(cfg, params_np, *, device=None):
    """The W8A16 weight bridge: the reference's quantized flat params
    (`GPT2.quantize_weights()` or the `export_generator` artifact's
    keys, as numpy) as the port's flat dict on `device` (None -> CUDA),
    name for name: int8 codes, scales and every other entry in their
    own float dtype. Raises on a missing, unexpected, misshaped or
    mistyped entry."""
    shapes = quantized_param_shapes(cfg)
    missing = sorted(set(shapes) - set(params_np))
    extra = sorted(set(params_np) - set(shapes))
    if missing or extra:
        raise ValueError(f"W8A16 reference params do not match GPT2Config: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    dev = resolve_device(device)
    out = {}
    for name, shape in shapes.items():
        t = _host_tensor(params_np[name])
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        codes = name.endswith("::w8c")
        if codes != (t.dtype == torch.int8) or not (
                codes or t.is_floating_point()):
            raise ValueError(f"{name}: dtype {t.dtype}, expected "
                             f"{'int8' if codes else 'a float dtype'}")
        out[name] = t.to(dev)
    return out


def from_reference_params(cfg, params_np, *, device=None):
    """The weight bridge: a `GPT2` holding exactly the reference's flat
    params (`functional_state()` converted to numpy), name for name and
    in the same `[in, out]` layout.

    Rejects the W8A16 `::w8c`/`::w8s` keys (a module holds float
    parameters: `quantized_params_from_reference` carries those into a
    flat dict) and any missing, unexpected or misshaped entry. Each
    tensor keeps its array's float dtype."""
    quant = sorted(k for k in params_np if "::w8" in k)
    if quant:
        raise ValueError(
            f"W8A16 weights ({quant[0]!r}, ...) cannot load into a GPT2 "
            f"module, which holds float parameters: carry them with "
            f"quantized_params_from_reference(cfg, params_np, device=...) "
            f"into a flat dict for the decoder")
    shapes = param_shapes(cfg)
    missing = sorted(set(shapes) - set(params_np))
    extra = sorted(set(params_np) - set(shapes))
    if missing or extra:
        raise ValueError(f"reference params do not match GPT2Config: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    model = GPT2(cfg, device=device, init=False)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = np.asarray(params_np[name])
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)  # bf16 numpy (ml_dtypes) et al.
            if tuple(a.shape) != tuple(shapes[name]):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{shapes[name]}")
            t = torch.from_numpy(np.array(a))  # a writable copy
            p.data = t.to(p.device)
    return model


__all__ = ["GPT2Config", "GPT2", "export_generator",
           "from_reference_params", "param_shapes",
           "quantize_decode_weights_int8", "quantized_param_shapes",
           "quantized_params_from_reference",
           "build_train_step", "hidden_states", "logits", "lm_loss"]
