"""The seq2seq Transformer for machine translation, the port of
`paddle_tpu/models/transformer.py`: an encoder-decoder over the layers of
`nn/layer/transformer.py` (post-LN, exact GELU), separate source and
target embeddings scaled by sqrt(d_model) plus sinusoidal positions, a
Linear generator over the target vocabulary.

`TransformerModel` holds the reference's modules under the reference's
attribute names, so `named_parameters()` spells the reference's
`functional_state()` keys (`src_embed.weight`,
`transformer.encoder.layers.{i}.self_attn.q_proj.weight`,
`transformer.decoder.layers.{i}.cross_attn...`, `generator.weight`;
every projection `[in, out]`) and `from_reference_params` is a
name-for-name copy of the reference's numpy weights. `pos_enc` is a
buffer outside the parameters, as the reference's.

What the reference fixes and the port keeps:
  * `forward(src_ids, tgt_ids, src_pad_mask=None)`: the [S, S] causal
    `tgt_mask` (0 / -1e30) on the decoder's self-attention (the dense
    path); a [B, S] 1/0 `src_pad_mask` becomes the additive [B, 1, 1, S]
    mask of the ENCODER only (K4 bias on the card): the cross-attention
    gets no memory mask, as in the reference;
  * `loss(src_ids, tgt_in, tgt_out, label_smoothing=0.1)`: the mean
    cross-entropy of the logits with label smoothing;
  * `greedy_decode(src_ids, max_len, use_cache=True)`: with the cache the
    source is encoded once and each step runs the decoder on one token
    against the layer caches (Cache for self-attention, StaticCache for
    the memory: two one-query attentions a layer, K4 at Sq = 1 on the
    card); without it every step re-runs the whole model. Both give the
    same tokens;
  * `beam_search_decode(src_ids, beam_size, max_len, length_penalty)`:
    the GNMT length penalty ((5 + len) / 6)^alpha, beam 0 alone live at
    the first step, finished beams frozen (only eos continues, at an
    unchanged score), every cache row reordered by its winning beam each
    step, the best hypothesis per row padded with eos after its first
    eos. Top-k is `ops.search.topk_impl`, which keeps `lax.top_k`'s order
    on ties (the lower index first).

Dtypes: the `pos_enc` slice is added in the embedding's dtype and the
masks reach attention in the embeddings' dtype. In float32 that is the
reference's arithmetic; in bf16 it keeps the trunk in bf16, where the
reference's float32 operands would promote it (and a float32 activation
meets bf16 weights in `addmm`, or a float32 softmax a bf16 V).

`TransformerModel(cfg, seed=0, dtype=torch.float32, device=None)`
initialises from a seeded CPU generator (embeddings normal(0, 1), the
reference's default; projections Xavier-uniform, biases zero, norms
(1, 0); every encoder layer, and every decoder layer, the same weights
as the reference's `_clone_layer` gives) and moves to `device`: CUDA
unless the caller passes device="cpu". `loss_with(model, params, ...)`
computes the loss with other parameters bound (bf16 copies of float32
masters, say) through `torch.func.functional_call`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import device_guard, resolve_device
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.transformer import Transformer
from ..ops.loss import cross_entropy
from ..ops.search import topk_impl


@dataclass
class TransformerConfig:
    src_vocab_size: int = 30000
    tgt_vocab_size: int = 30000
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    max_length: int = 256
    bos_id: int = 0
    eos_id: int = 1

    @classmethod
    def tiny(cls):
        return cls(src_vocab_size=512, tgt_vocab_size=512, d_model=64,
                   nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                   dim_feedforward=128, max_length=64)


def sinusoid_position_encoding(max_len, d_model):
    """[max_len, d_model] float32: sin on even columns, cos on odd ones,
    at angles pos / 10000^(2 (i // 2) / d_model) (the reference's numpy
    code)."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000, 2 * (i // 2) / d_model)
    enc = np.zeros((max_len, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


class TransformerModel(nn.Module):
    def __init__(self, cfg: TransformerConfig = None, *, seed=0,
                 dtype=torch.float32, device=None, **kw):
        super().__init__()
        cfg = cfg or TransformerConfig(**kw)
        self.cfg = cfg
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        d = cfg.d_model
        with device_guard("cpu"):  # built on the CPU, then moved
            self.src_embed = Embedding(cfg.src_vocab_size, d,
                                       init_generator=g)
            self.tgt_embed = Embedding(cfg.tgt_vocab_size, d,
                                       init_generator=g)
            self.register_buffer("pos_enc", torch.from_numpy(
                sinusoid_position_encoding(cfg.max_length, d)),
                persistent=False)
            self.transformer = Transformer(
                d_model=d, nhead=cfg.nhead,
                num_encoder_layers=cfg.num_encoder_layers,
                num_decoder_layers=cfg.num_decoder_layers,
                dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout,
                activation="gelu", init_generator=g)
            self.generator = Linear(d, cfg.tgt_vocab_size, init_generator=g)
        self.dropout = Dropout(cfg.dropout)
        self.scale = math.sqrt(d)
        self.to(device=dev, dtype=dtype)

    def _ids(self, ids):
        """Token ids (a tensor or an array) on the model's device."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids))
        return ids.to(self.pos_enc.device)

    def _embed_at(self, table, ids, start):
        """dropout(table(ids) * sqrt(d_model) + pos_enc[start:start + S]),
        the positions added in the embedding's dtype."""
        x = table(ids) * self.scale
        pe = self.pos_enc[start:start + ids.shape[1]]
        return self.dropout(x + pe.to(x.dtype))

    def forward(self, src_ids, tgt_ids, src_pad_mask=None):
        """Logits [B, S_tgt, V] in the parameters' dtype."""
        src = self._embed_at(self.src_embed, self._ids(src_ids), 0)
        tgt = self._embed_at(self.tgt_embed, self._ids(tgt_ids), 0)
        tgt_mask = self.transformer.generate_square_subsequent_mask(
            tgt.shape[1], tgt.device).to(tgt.dtype)
        src_mask = None
        if src_pad_mask is not None:
            m = self._ids(src_pad_mask).float()[:, None, None, :]
            src_mask = ((1.0 - m) * -1e30).to(src.dtype)
        out = self.transformer(src, tgt, src_mask=src_mask,
                               tgt_mask=tgt_mask)
        # the generator as one rank-2 product over [B*S, E] (the
        # reference's layout choice)
        b, s = out.shape[0], out.shape[1]
        logits = self.generator(out.reshape(-1, self.cfg.d_model))
        return logits.reshape(b, s, self.cfg.tgt_vocab_size)

    def loss(self, src_ids, tgt_in, tgt_out, label_smoothing=0.1):
        logits = self(src_ids, tgt_in)
        return cross_entropy(logits.reshape(-1, self.cfg.tgt_vocab_size),
                             self._ids(tgt_out).reshape(-1),
                             label_smoothing=label_smoothing)

    def _bos(self, rows):
        return torch.full((rows, 1), self.cfg.bos_id, dtype=torch.int32,
                          device=self.pos_enc.device)

    def _decode_step(self, tok, step, memory, caches):
        """One cached decoder step: logits [B, V] of token `tok` [B, 1] at
        position `step`, and the caches grown by it."""
        t = self._embed_at(self.tgt_embed, tok, step)
        out, caches = self.transformer.decoder(t, memory, None, None,
                                               caches)
        return self.generator(out[:, -1]), caches

    @torch.no_grad()
    def greedy_decode(self, src_ids, max_len=32, use_cache=True):
        """Greedy generation: [B, max_len] int32 tokens, bos first. With
        `use_cache` the source is encoded once and the decoder runs one
        token a step against its layer caches; without it every step
        re-runs the whole model. Both give the same tokens."""
        src_ids = self._ids(src_ids)
        b = src_ids.shape[0]
        if not use_cache:
            tgt = self._bos(b)
            for _ in range(max_len - 1):
                nxt = self(src_ids, tgt)[:, -1].argmax(-1)
                tgt = torch.cat([tgt, nxt.to(torch.int32)[:, None]], dim=1)
            return tgt
        memory = self.transformer.encoder(
            self._embed_at(self.src_embed, src_ids, 0), None)
        caches = self.transformer.decoder.gen_cache(memory)
        toks = [self._bos(b)]
        for step in range(max_len - 1):
            logits, caches = self._decode_step(toks[-1], step, memory,
                                               caches)
            toks.append(logits.argmax(-1).to(torch.int32)[:, None])
        return torch.cat(toks, dim=1)

    @torch.no_grad()
    def beam_search_decode(self, src_ids, beam_size=4, max_len=32,
                           length_penalty=0.6):
        """Beam search with the GNMT length penalty ((5 + len) / 6)^alpha:
        the best hypothesis of each row, [B, <= max_len] int32, eos after
        its first eos. Finished beams are frozen (only an eos continuation,
        at an unchanged score); beam_size 1 gives greedy_decode's tokens
        up to the first eos."""
        src = self._ids(src_ids)
        dev = src.device
        B, K, V = src.shape[0], int(beam_size), self.cfg.tgt_vocab_size
        eos = self.cfg.eos_id
        tgt = self._bos(B * K)
        # only beam 0 is live at the first step: otherwise K equal beams
        scores = torch.tensor([0.0] + [-1e9] * (K - 1), dtype=torch.float32,
                              device=dev).repeat(B, 1)            # [B, K]
        finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
        row = torch.arange(B, device=dev)[:, None]
        eos_only = torch.where(torch.arange(V, device=dev) == eos, 0.0,
                               -torch.inf)[None, None, :]
        memory = self.transformer.encoder(self._embed_at(
            self.src_embed, src.repeat_interleave(K, dim=0), 0), None)
        caches = self.transformer.decoder.gen_cache(memory)
        step_tok = tgt
        for pos in range(max_len - 1):
            logits, caches = self._decode_step(step_tok, pos, memory, caches)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            cont = scores[:, :, None] + torch.where(finished[:, :, None],
                                                    eos_only, logp)
            top_s, top_i = topk_impl(cont.reshape(B, K * V), K)
            top_i = top_i.long()
            beam_idx = top_i // V                                 # [B, K]
            tok = (top_i % V).to(torch.int32)
            gather = (row * K + beam_idx).reshape(-1)
            tgt = torch.cat([tgt[gather], tok.reshape(-1, 1)], dim=1)
            # every cache row follows its winning beam
            caches = [tuple(type(c)(c.k[gather], c.v[gather]) for c in layer)
                      for layer in caches]
            step_tok = tok.reshape(-1, 1)
            finished = finished[row, beam_idx] | (tok == eos)
            scores = top_s
            if bool(finished.all()):
                break
        # a hypothesis's length counts its tokens up to its first eos
        seq = tgt.reshape(B, K, -1)
        T = seq.shape[-1]
        is_eos = seq == eos
        first_eos = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                                T - 1)                            # [B, K]
        lengths = (first_eos + 1).float()
        lp = ((5.0 + lengths) / 6.0) ** length_penalty
        best = (scores / lp).argmax(-1)                           # [B]
        rows = torch.arange(B, device=dev)
        out = seq[rows, best]
        cut = torch.where(is_eos[rows, best].any(-1), first_eos[rows, best],
                          T - 1)[:, None]
        return torch.where(torch.arange(T, device=dev)[None, :] <= cut, out,
                           eos).to(torch.int32)


class _Loss(nn.Module):
    """`model.loss` as a forward, so `functional_call` can bind parameters
    to it."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.loss(*args, **kwargs)


def loss_with(model, params, *args, **kwargs):
    """`model.loss(*args, **kwargs)` computed with `params` ({name:
    tensor}, the names of `model.named_parameters()`) in place of the
    model's own, through `torch.func.functional_call`."""
    return torch.func.functional_call(
        _Loss(model), {f"model.{n}": p for n, p in params.items()}, args,
        kwargs)


def param_shapes(cfg):
    """{name: shape} of a `TransformerModel(cfg)`: the reference's
    `functional_state()` keys, projections `[in, out]`."""
    d, f = cfg.d_model, cfg.dim_feedforward
    shapes = {"src_embed.weight": (cfg.src_vocab_size, d),
              "tgt_embed.weight": (cfg.tgt_vocab_size, d)}

    def attn(prefix):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{prefix}.{proj}.weight"] = (d, d)
            shapes[f"{prefix}.{proj}.bias"] = (d,)

    for side, n, attns, norms in (
            ("encoder", cfg.num_encoder_layers, ("self_attn",),
             ("norm1", "norm2")),
            ("decoder", cfg.num_decoder_layers, ("self_attn", "cross_attn"),
             ("norm1", "norm2", "norm3"))):
        for i in range(n):
            p = f"transformer.{side}.layers.{i}."
            for a in attns:
                attn(p + a)
            shapes.update({p + "linear1.weight": (d, f),
                           p + "linear1.bias": (f,),
                           p + "linear2.weight": (f, d),
                           p + "linear2.bias": (d,)})
            for norm in norms:
                shapes[p + f"{norm}.weight"] = (d,)
                shapes[p + f"{norm}.bias"] = (d,)
    shapes["generator.weight"] = (d, cfg.tgt_vocab_size)
    shapes["generator.bias"] = (cfg.tgt_vocab_size,)
    return shapes


def from_reference_params(cfg, params_np, device=None):
    """The weight bridge: a `TransformerModel(cfg)` on `device` (None ->
    CUDA) holding exactly the reference's params (`functional_state()`
    converted to numpy), name for name and in the same `[in, out]`
    layouts, as float32. Rejects any missing, unexpected or misshaped
    entry."""
    shapes = param_shapes(cfg)
    missing = sorted(set(shapes) - set(params_np))
    extra = sorted(set(params_np) - set(shapes))
    if missing or extra:
        raise ValueError(f"reference params do not match the config: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    for name, shape in shapes.items():
        if tuple(np.shape(params_np[name])) != shape:
            raise ValueError(f"{name}: shape {np.shape(params_np[name])}, "
                             f"expected {shape}")
    model = TransformerModel(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = np.asarray(params_np[name], dtype=np.float32)
            p.copy_(torch.from_numpy(a.copy()))
    return model


__all__ = ["TransformerConfig", "TransformerModel",
           "sinusoid_position_encoding", "param_shapes",
           "from_reference_params", "loss_with"]
