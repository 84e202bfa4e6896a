"""The encoder half of `paddle_tpu/nn/layer/transformer.py`:
`MultiHeadAttention` (with its `Cache`/`StaticCache` and `need_weights`),
`TransformerEncoderLayer` (post-LN or, with `normalize_before`, pre-LN)
and `TransformerEncoder`, as `torch.nn.Module`s with the reference's
attribute names, so `named_parameters()` spells the reference's
`functional_state()` keys (`layers.0.self_attn.q_proj.weight`, ...).

Attention goes through `ops.scaled_dot_product_attention`, which picks
its route from the arguments as the reference does: a [B, 1, 1, S]
padding mask reaches the per-key-bias flash kernels, dropout or the
weights output the dense path. `TransformerEncoder` deep-copies its
first layer, as the reference's `_clone_layer` does, so every layer
starts with the same weights.

The decoder half (`TransformerDecoderLayer`, `TransformerDecoder`,
`Transformer`) is not ported yet.
"""
from __future__ import annotations

import collections
import copy

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import NEG_INF, scaled_dot_product_attention
from .common import Dropout, Linear
from .norm import LayerNorm


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = attend) becomes the additive 0 / -1e30 mask in
    `dtype`; any other mask is returned as it is."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, 0.0, NEG_INF).to(dtype)


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, *, init_generator=None):
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
        self.generator = None  # attention dropout's generator
        g = init_generator
        self.q_proj = Linear(embed_dim, embed_dim, init_generator=g)
        self.k_proj = Linear(self.kdim, embed_dim, init_generator=g)
        self.v_proj = Linear(self.vdim, embed_dim, init_generator=g)
        self.out_proj = Linear(embed_dim, embed_dim, init_generator=g)

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
        out, weights = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            return_weights=self.need_weights, generator=self.generator)

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
        """A StaticCache of key/value's projections, or an empty
        incremental Cache ([B, H, 0, D] float32, as the reference's)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        z = torch.zeros(key.shape[0], self.num_heads, 0, self.head_dim,
                        dtype=torch.float32, device=key.device)
        return self.Cache(z, z.clone())


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, init_generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        g = init_generator
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            init_generator=g)
        self.linear1 = Linear(d_model, dim_feedforward, init_generator=g)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, init_generator=g)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        # "gelu" is the exact (erf) GELU, as the reference's ops.gelu
        self.activation = getattr(F, activation)

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


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
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


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "set_dropout_generator"]
