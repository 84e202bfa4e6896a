"""`paddle_tpu/nn/layer/transformer.py` as `Layer`s:
`MultiHeadAttention` (with its `Cache`/`StaticCache` and `need_weights`),
`TransformerEncoderLayer` / `TransformerDecoderLayer` (post-LN or, with
`normalize_before`, pre-LN), `TransformerEncoder` / `TransformerDecoder`
and `Transformer`, with the reference's attribute names, so
`named_parameters()` spells the reference's `functional_state()` keys
(`layers.0.self_attn.q_proj.weight`, `decoder.layers.0.cross_attn...`).

Attention goes through `ops.scaled_dot_product_attention`, which picks
its route from the arguments as the reference does: no mask reaches the
flash kernels (K4, K6 + K9), a [B, 1, 1, S] padding mask their
per-key-bias variants, and any other mask (the decoder's [S, S] causal
`tgt_mask`), dropout or the weights output the dense path. A cached
decode step is one query (Sq = 1) against the self-attention cache and
the memory. `TransformerEncoder` and `TransformerDecoder` deep-copy
their first layer, as the reference's `_clone_layer` does, so every
layer starts with the same weights.

The layers take the reference's signatures (`weight_attr`, `bias_attr`
for every projection) and the port's keyword `init_generator=` (the
models' way: every parameter drawn from that generator, on its device).
Attention consults `amp` under the reference's op name
"scaled_dot_product_attention": it runs in the amp dtype at O2, or when
that name is in `custom_white_list`, and its output comes back in
float32; at the default O1 it runs in the dtype of the projections'
output (float32, as the reference's).

Two choices of the port in `MultiHeadAttention.gen_cache`, each the
reference's values in float32: the empty incremental `Cache` is made in
the projections' dtype (the reference's is float32 always, which in
bf16 would promote every concatenated K/V to float32), and a
`StaticCache` is stored contiguous once (the flash kernels read
contiguous rows; a view would be copied again at every decode step).
"""
from __future__ import annotations

import collections
import contextlib
import copy

import torch

from ... import amp
from ...device import device_guard
from ...ops import nn_ops
from ...ops.attention import NEG_INF, scaled_dot_product_attention
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm


def _built_on(generator):
    """Build under the generator's device (the models' CPU build)."""
    return device_guard(generator.device) if generator is not None \
        else contextlib.nullcontext()


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = attend) becomes the additive 0 / -1e30 mask in
    `dtype`; any other mask is returned as it is."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, 0.0, NEG_INF).to(dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, fuse_attention=True, *,
                 init_generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.fuse_attention = fuse_attention
        self.generator = None  # attention dropout's generator
        g, wa, ba = init_generator, weight_attr, bias_attr
        self.q_proj = Linear(embed_dim, embed_dim, wa, ba, init_generator=g)
        self.k_proj = Linear(self.kdim, embed_dim, wa, ba, init_generator=g)
        self.v_proj = Linear(self.vdim, embed_dim, wa, ba, init_generator=g)
        self.out_proj = Linear(embed_dim, embed_dim, wa, ba,
                               init_generator=g)

    def _split_heads(self, x):
        """[B, S, E] -> [B, H, S, D]."""
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim) \
            .permute(0, 2, 1, 3)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=2)
            v = torch.cat([cache.v, v], dim=2)
            cache = self.Cache(k, v)

        attn_mask = _convert_attention_mask(attn_mask, q.dtype)
        (q, k, v, attn_mask), back = amp.cast_inputs(
            "scaled_dot_product_attention", q, k, v, attn_mask)
        out, weights = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            return_weights=self.need_weights, generator=self.generator)
        out, weights = back(out), back(weights)

        b, s = out.shape[0], out.shape[2]
        out = self.out_proj(out.permute(0, 2, 1, 3)
                            .reshape(b, s, self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """A StaticCache of key/value's projections, stored contiguous, or
        an empty incremental Cache ([B, H, 0, D] in the projections'
        dtype; the reference's is float32, the same in a float32
        model)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key)).contiguous()
            v = self._split_heads(self.v_proj(
                value if value is not None else key)).contiguous()
            return self.StaticCache(k, v)
        z = torch.zeros(key.shape[0], self.num_heads, 0, self.head_dim,
                        dtype=self.k_proj.weight.dtype, device=key.device)
        return self.Cache(z, z.clone())


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 init_generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        g, wa, ba = init_generator, weight_attr, bias_attr
        self.normalize_before = normalize_before
        with _built_on(g):
            self.self_attn = MultiHeadAttention(
                d_model, nhead, attn_dropout, weight_attr=wa, bias_attr=ba,
                init_generator=g)
            self.linear1 = Linear(d_model, dim_feedforward, wa, ba,
                                  init_generator=g)
            self.dropout = Dropout(act_dropout)
            self.linear2 = Linear(dim_feedforward, d_model, wa, ba,
                                  init_generator=g)
            self.norm1 = LayerNorm(d_model)
            self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        # "gelu" is the exact (erf) GELU, as the reference's ops.gelu
        self.activation = getattr(nn_ops, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


def set_dropout_generator(module, generator):
    """Point every dropout under `module` (each `Dropout` and the
    attention dropout of each `MultiHeadAttention`) at `generator`."""
    for m in module.modules():
        if isinstance(m, (Dropout, MultiHeadAttention)):
            m.generator = generator


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 init_generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        g, wa, ba = init_generator, weight_attr, bias_attr
        self.normalize_before = normalize_before
        with _built_on(g):
            self.self_attn = MultiHeadAttention(
                d_model, nhead, attn_dropout, weight_attr=wa, bias_attr=ba,
                init_generator=g)
            self.cross_attn = MultiHeadAttention(
                d_model, nhead, attn_dropout, weight_attr=wa, bias_attr=ba,
                init_generator=g)
            self.linear1 = Linear(d_model, dim_feedforward, wa, ba,
                                  init_generator=g)
            self.dropout = Dropout(act_dropout)
            self.linear2 = Linear(dim_feedforward, d_model, wa, ba,
                                  init_generator=g)
            self.norm1 = LayerNorm(d_model)
            self.norm2 = LayerNorm(d_model)
            self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(nn_ops, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """Self-attention (under `tgt_mask`; with `cache[0]`, an
        incremental Cache, against the tokens before too), attention over
        `memory` (with `cache[1]`, a StaticCache, over its K/V), then the
        feed-forward block. Returns tgt, or (tgt, (Cache, StaticCache))
        with a cache."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            inc_cache = None
        else:
            tgt, inc_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                            cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (inc_cache, static_cache))

    def gen_cache(self, memory):
        """(an empty incremental Cache, the StaticCache of memory's K/V)."""
        inc = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return inc, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory):
        """One (Cache, StaticCache) per layer."""
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 init_generator=None):
        super().__init__()
        with _built_on(init_generator):
            self._build(d_model, nhead, num_encoder_layers,
                        num_decoder_layers, dim_feedforward, dropout,
                        activation, attn_dropout, act_dropout,
                        normalize_before, weight_attr, bias_attr,
                        custom_encoder, custom_decoder, init_generator)
        self.d_model = d_model
        self.nhead = nhead

    def _build(self, d_model, nhead, num_encoder_layers, num_decoder_layers,
               dim_feedforward, dropout, activation, attn_dropout,
               act_dropout, normalize_before, wa, ba, custom_encoder,
               custom_decoder, g):
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, wa, ba,
                init_generator=g)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, wa, ba,
                init_generator=g)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] float32: 0 on and below the diagonal, -1e30
        above it (the reference's additive causal mask)."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=device).tril()
        return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "set_dropout_generator"]
