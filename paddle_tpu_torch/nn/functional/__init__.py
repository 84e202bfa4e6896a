"""`paddle.nn.functional` of the port: the 2.0 functional names of
`paddle_tpu/nn/functional/__init__.py:6-25` (the ops of `ops.nn_ops` and
`ops.loss`) and its own functions — `sequence_mask`, `diag_embed`,
`adaptive_max_pool3d`, `spectral_norm`, `layer_norm` with the 2.0
signature `(x, normalized_shape, weight, bias, epsilon)`. The fluid-era
ops the legacy layers run are in `legacy` (`pool2d`, `pool3d`,
`gather_tree`, `hsigmoid_loss`, `bilinear`); the rest of the reference's
`legacy`, `sequence` and `detection` re-exports are not ported yet
(ROADMAP §A 10 (e3))."""
from __future__ import annotations

import sys as _sys

import torch

from ...core import dtype as dtype_mod
from ...ops import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    affine_grid, alpha_dropout, avg_pool1d, avg_pool2d, avg_pool3d,
    batch_norm, binary_cross_entropy, binary_cross_entropy_with_logits,
    celu, conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose, cosine_embedding_loss, cosine_similarity,
    cross_entropy, ctc_loss, dropout, dropout2d, dropout3d, elu, embedding,
    gelu, glu, grid_sample, group_norm, gumbel_softmax, hardshrink,
    hardsigmoid, hardswish, hardtanh, hinge_loss, instance_norm,
    interpolate, kl_div, l1_loss, label_smooth, leaky_relu, linear,
    local_response_norm, log_loss, log_sigmoid, log_softmax,
    margin_ranking_loss, max_pool1d, max_pool2d, max_pool3d, maxout, mish,
    mse_loss, nll_loss, normalize, npair_loss, one_hot, pad,
    pairwise_distance, pixel_shuffle, pixel_unshuffle, prelu, relu, relu6,
    rms_norm, scaled_dot_product_attention, selu, sigmoid,
    sigmoid_focal_loss, silu, smooth_l1_loss, softmax,
    softmax_with_cross_entropy, softplus, softshrink, softsign,
    square_error_cost, stanh, swish, tanh, tanhshrink, temporal_shift,
    thresholded_relu, triplet_margin_loss, unfold, upsample,
)
from ...ops import diag_embed  # noqa: F401
from . import legacy  # noqa: F401
from .legacy import (bilinear, gather_tree, hsigmoid_loss,  # noqa: F401
                     pool2d, pool3d)
from ...ops import nn_ops as _nn_ops

grid_sampler = grid_sample
sigmoid_cross_entropy_with_logits = binary_cross_entropy_with_logits


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """[..., maxlen] mask: position < length (maxlen: the longest)."""
    m = int(maxlen) if maxlen is not None else int(lengths.max())
    pos = torch.arange(m, device=lengths.device)
    return (pos < lengths[..., None]).to(dtype_mod.convert_dtype(dtype))


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight / σ, σ by power iteration from ones (the reference's
    functional form; the layer keeps its vectors, `nn.SpectralNorm`)."""
    perm = [dim] + [i for i in range(weight.dim()) if i != dim]
    mat = weight.permute(perm).reshape(weight.shape[dim], -1)
    u = torch.ones(mat.shape[0], dtype=mat.dtype, device=mat.device)
    v = torch.ones(mat.shape[1], dtype=mat.dtype, device=mat.device)
    for _ in range(max(power_iters, 1)):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    out = (mat / (u @ mat @ v)).reshape([weight.shape[p] for p in perm])
    return out.permute([perm.index(i) for i in range(weight.dim())])


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-05, name=None, **kw):
    """The 2.0 signature (x, normalized_shape, weight, bias, epsilon); a
    tensor in the second slot is the op's (x, weight, bias, epsilon)
    order, shifted back into place, as the reference accepts."""
    if normalized_shape is not None and not isinstance(
            normalized_shape, (int, tuple, list)):
        real_w, real_b = normalized_shape, weight
        if bias is not None and isinstance(bias, (int, float)):
            real_eps = float(bias)
        else:
            real_b = real_b if real_b is not None else bias
            real_eps = epsilon
        return _nn_ops.layer_norm(x, real_w, real_b, epsilon=real_eps, **kw)
    ndim = 1 if normalized_shape is None else (
        1 if isinstance(normalized_shape, int) else len(normalized_shape))
    return _nn_ops.layer_norm(x, weight, bias, epsilon=epsilon,
                              normalized_ndim=ndim, **kw)


# topic submodule aliases (the reference organizes functional this way)
_self = _sys.modules[__name__]
activation = _self
conv = _self
loss = _self
norm = _self
pooling = _self
vision = _self
input = _self  # noqa: A001
