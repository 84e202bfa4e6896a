"""fluid.nets — composed multi-op building blocks.

Reference: python/paddle/fluid/nets.py (simple_img_conv_pool:29,
img_conv_group:143, sequence_conv_pool:261, glu:335,
scaled_dot_product_attention:382; the port of `paddle_tpu/fluid/nets.py`).
Each composes the port's ops, and in a static Program records them.
`scaled_dot_product_attention` is a plain composition in the reference
(`paddle_tpu/fluid/nets.py:74-111`, no Pallas kernel), so it stays torch
ops here.
"""
from __future__ import annotations

import torch

from ..static import nn as _snn
from .. import ops as _ops


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,  # noqa: A002
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv = _snn.conv2d(input, num_filters, filter_size, stride=conv_stride,
                       padding=conv_padding, dilation=conv_dilation,
                       groups=conv_groups, param_attr=param_attr,
                       bias_attr=bias_attr, act=act)
    return _snn.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                       pool_stride=pool_stride, pool_padding=pool_padding,
                       global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,  # noqa: A002
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _per_conv(v, n):
        return v if isinstance(v, (list, tuple)) else [v] * n

    n = len(conv_num_filter)
    paddings = _per_conv(conv_padding, n)
    fsizes = _per_conv(conv_filter_size, n)
    with_bn = _per_conv(conv_with_batchnorm, n)
    drops = _per_conv(conv_batchnorm_drop_rate, n)
    out = input
    for i, nf in enumerate(conv_num_filter):
        out = _snn.conv2d(out, nf, fsizes[i], padding=paddings[i],
                          param_attr=param_attr,
                          act=None if with_bn[i] else conv_act)
        if with_bn[i]:
            out = _snn.batch_norm(out, act=conv_act)
            if drops[i] > 0:
                out = _snn.dropout(out, dropout_prob=drops[i])
    return _snn.pool2d(out, pool_size=pool_size, pool_type=pool_type,
                       pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,  # noqa: A002
                       act="sigmoid", pool_type="max", bias_attr=None):
    from ..nn.functional.sequence import sequence_conv, sequence_pool
    from ..static.nn import _create_param
    w = _create_param((filter_size * int(input.shape[-1]), num_filters),
                      "float32", param_attr)
    b = _create_param((num_filters,), "float32", bias_attr, is_bias=True)
    conv = sequence_conv(input, w, bias=b, context_length=filter_size)
    if act:
        conv = getattr(_ops, act)(conv)
    return sequence_pool(conv, pool_type)


def glu(input, dim=-1):  # noqa: A002
    return _ops.glu(input, axis=dim)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """[B, S, D] q/k/v -> multi-head scaled-dot attention, heads
    re-merged: the reference's composition of einsums and a softmax."""
    q, k, v = queries, keys, values
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("inputs must be 3-D [batch, seq, hidden]")
    if q.shape[-1] % num_heads or k.shape[-1] % num_heads \
            or v.shape[-1] % num_heads:
        raise ValueError("hidden size must be divisible by num_heads")

    def split(t):  # [B,S,D] -> [B,H,S,D/H]
        b, s, d = t.shape
        return t.reshape(b, s, num_heads, d // num_heads).permute(
            0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / \
        float(qh.shape[-1]) ** 0.5
    weights = _ops.softmax(scores, axis=-1)
    if dropout_rate:
        weights = _snn.dropout(weights, dropout_prob=dropout_rate)
    ctx = torch.einsum("bhqk,bhkd->bhqd", weights, vh)
    b, h, s, dh = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h * dh)
