"""`paddle.nn.functional` of the port: the 2.0 functional names of
`paddle_tpu/nn/functional/__init__.py:6-25` (the ops of `ops.nn_ops` and
`ops.loss`) and its own functions — `sequence_mask`, `diag_embed`,
`adaptive_max_pool3d`, `spectral_norm`, `layer_norm` with the 2.0
signature `(x, normalized_shape, weight, bias, epsilon)`, and the
fluid-era names the reference re-exports (`:107-153`): the sequence ops
on dense padded tensors (`sequence`), the legacy layers, losses, RNN
layer functions and shims (`legacy`), the detection suite (`detection`) and
`roi_align` (`vision.ops`)."""
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
from . import detection, legacy, sequence, transformer  # noqa: F401
from .sequence import (  # noqa: F401
    sequence_concat, sequence_conv, sequence_enumerate, sequence_expand,
    sequence_expand_as, sequence_first_step, sequence_last_step, sequence_pad,
    sequence_pool, sequence_reshape, sequence_reverse, sequence_scatter,
    sequence_slice, sequence_softmax, sequence_unpad,
)
from .legacy import (  # noqa: F401
    add_position_encoding, affine_channel, array_length, array_read,
    array_write, assign, autoincreased_step_counter, bilinear,
    bilinear_tensor_product, bpr_loss, birnn, center_loss,
    continuous_value_model, create_array, data_norm, deformable_conv,
    dice_loss, dynamic_gru, dynamic_lstm, dynamic_lstmp, erf, fc,
    filter_by_instag, fsp_matrix, gather_tree, gru_unit, hash,
    hsigmoid_loss, im2sequence, image_resize, image_resize_short,
    legacy_param_store, linear_chain_crf, crf_decoding, lod_append,
    lod_reset, lstm, lstm_unit,
    merge_selected_rows, nce, pad2d, pad_constant_like, polygon_box_transform,
    pool2d, pool3d, random_crop, reorder_lod_tensor_by_rank, resize_bilinear,
    resize_nearest, resize_trilinear, row_conv, smooth_l1, soft_relu,
    space_to_depth, shuffle_channel, similarity_focus,
    teacher_student_sigmoid_loss, tensor_array_to_tensor, warpctc,
)
from .detection import (  # noqa: F401
    anchor_generator, bipartite_match, box_clip, box_coder,
    box_decoder_and_assign, collect_fpn_proposals, deformable_roi_pooling,
    density_prior_box, detection_output, distribute_fpn_proposals,
    generate_mask_labels, generate_proposal_labels, generate_proposals,
    multi_box_head, multiclass_nms, prior_box, prroi_pool, psroi_pool,
    retinanet_detection_output, retinanet_target_assign,
    roi_perspective_transform, roi_pool, rpn_target_assign, target_assign,
    yolo_box, yolov3_loss,
)
from .transformer import (fused_feedforward,  # noqa: F401
                          fused_multi_head_attention)
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


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    from ...vision.ops import roi_align as _ra
    return _ra(x, boxes, boxes_num=boxes_num, output_size=output_size,
               spatial_scale=spatial_scale, sampling_ratio=sampling_ratio,
               aligned=aligned)


# topic submodule aliases (the reference organizes functional this way)
common = legacy
extension = legacy
rnn = sequence
_self = _sys.modules[__name__]
activation = _self
conv = _self
loss = _self
norm = _self
pooling = _self
vision = _self
input = _self  # noqa: A001
