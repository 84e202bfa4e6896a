"""fluid.layers functional namespace (ref: python/paddle/fluid/layers/;
the port of `paddle_tpu/fluid/layers.py`).

Static-graph builders come from `static.nn`; tensor ops come from the
op library (usable in both modes, recorded into a Program when they take
its Variables); the fluid-era functional ops from `nn.functional`'s
`sequence`, `detection` and `legacy` modules, one implementation each.
"""
from __future__ import annotations

import torch

from .. import ops as _ops
from ..core import dtype as dtype_mod
from ..ops import *  # noqa: F401,F403
from ..static.nn import (  # noqa: F401
    batch_norm, bilinear_tensor_product, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose, crf_decoding, data_norm, deform_conv2d as
    deformable_conv, dropout, embedding, fc, group_norm, instance_norm,
    layer_norm, multi_box_head, nce, pool2d, prelu, py_func, row_conv,
    spectral_norm,
)
from ..ops.control import (  # noqa: F401
    case, cond, switch_case, while_loop,
)
# dense LoD reworks (layout contract: nn/functional/sequence.py docstring)
from ..nn.functional.sequence import (  # noqa: F401
    sequence_concat, sequence_conv, sequence_enumerate, sequence_expand,
    sequence_expand_as, sequence_first_step, sequence_last_step,
    sequence_pad, sequence_pool, sequence_reshape, sequence_reverse,
    sequence_scatter, sequence_slice, sequence_softmax, sequence_unpad,
)
from ..nn.functional.detection import (  # noqa: F401
    anchor_generator, bipartite_match, box_clip, box_coder,
    box_decoder_and_assign, collect_fpn_proposals, density_prior_box,
    detection_output, deformable_roi_pooling, distribute_fpn_proposals,
    generate_mask_labels, generate_proposal_labels, generate_proposals,
    multiclass_nms, prior_box, prroi_pool, psroi_pool,
    retinanet_detection_output, retinanet_target_assign,
    roi_perspective_transform, roi_pool, rpn_target_assign, target_assign,
    yolo_box, yolov3_loss,
)
from ..nn.functional import (  # noqa: F401
    linear_chain_crf, roi_align, sequence_mask,
)
from ..nn.functional.detection import iou_similarity, ssd_loss  # noqa: F401
# the canonical fluid-1.x shims (fresh-params-per-unnamed-call semantics +
# LegacyParamStore for named reuse) — single source of truth, NOT
# re-implemented here (code-review r3c)
from ..nn.functional.legacy import (  # noqa: F401
    add_position_encoding, affine_channel, array_length, array_read,
    array_write, autoincreased_step_counter, birnn, bpr_loss, center_loss,
    continuous_value_model, create_array, dice_loss, dynamic_gru,
    dynamic_lstm, dynamic_lstmp, filter_by_instag, fsp_matrix, gather_tree,
    gru_unit, hash, im2sequence, image_resize, image_resize_short,
    lod_append, lod_reset, lstm, lstm_unit, merge_selected_rows, pad2d,
    pad_constant_like, polygon_box_transform, pool3d, random_crop,
    reorder_lod_tensor_by_rank, resize_bilinear, resize_nearest,
    resize_trilinear, shuffle_channel, similarity_focus, smooth_l1,
    soft_relu, space_to_depth, teacher_student_sigmoid_loss,
    tensor_array_to_tensor, warpctc,
)
# 1.x RNN-cell / decoder classes live on in paddle.nn
from ..nn import (  # noqa: F401
    BeamSearchDecoder, GRUCell, LSTMCell, dynamic_decode,
)
from ..nn.layer.rnn import RNNCellBase as RNNCell  # noqa: F401
# distributions kept their 1.x home in fluid.layers (ref:
# fluid/layers/distributions.py)
from ..distribution import (  # noqa: F401
    Categorical, Normal, Uniform,
)
from .layers_legacy import *  # noqa: F401,F403,E402
from .layers_legacy import (  # noqa: F401
    edit_distance, lrn, mean_iou, multiplex,
    rank_loss, sampled_softmax_with_cross_entropy,
)
from .layers_legacy2 import *  # noqa: F401,F403,E402
from .layers_legacy2 import (  # noqa: F401
    Assert, BasicDecoder, DecodeHelper, Decoder, DynamicRNN,
    GreedyEmbeddingHelper, IfElse, MultivariateNormalDiag, Print,
    SampleEmbeddingHelper, StaticRNN, Switch, TrainingHelper, While,
)


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    from ..static import data as static_data
    if append_batch_size:
        shape = [-1] + list(shape)
    return static_data(name, shape, dtype)


def fill_constant(shape, dtype, value, name=None, out=None):
    return _ops.full(shape, value, dtype)


def reduce_sum(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.sum(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.mean(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _ops.max(input, axis=dim, keepdim=keep_dim)


def elementwise_add(x, y, axis=-1, name=None):
    return _ops.add(x, y)


def elementwise_sub(x, y, axis=-1, name=None):
    return _ops.subtract(x, y)


def elementwise_mul(x, y, axis=-1, name=None):
    return _ops.multiply(x, y)


def elementwise_div(x, y, axis=-1, name=None):
    return _ops.divide(x, y)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _ops.matmul(_ops.flatten(x, x_num_col_dims) if x.ndim > 2 else x,
                       y)


def mean(x, name=None):
    return _ops.mean(x)


def accuracy(input, label, k=1, **kw):  # noqa: A002
    from ..metric import accuracy as acc
    return acc(input, label, k)


def softmax_with_cross_entropy(logits, label, **kw):
    return _ops.softmax_with_cross_entropy(logits, label, **kw)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):  # noqa: A002
    return _ops.cross_entropy(input, label, soft_label=soft_label,
                              ignore_index=ignore_index, reduction="none",
                              use_softmax=False)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter (ref: fluid/layers/tensor.py create_parameter): of the
    current Program in static mode, else a live `Parameter` on the
    default device."""
    from ..core.mode import in_static_mode
    from ..core.param_attr import ParamAttr
    if in_static_mode():
        from ..static.nn import create_parameter as static_create
        return static_create(shape, dtype, name, attr, is_bias,
                             default_initializer)
    from ..core.tensor import make_parameter
    from ..nn import initializer as I
    attr = ParamAttr._to_attr(attr) if attr is not None \
        else ParamAttr(name=name)
    init = attr.initializer or default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierUniform())
    return make_parameter(init(shape, dtype), name=attr.name,
                          trainable=attr.trainable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable filled with `value` (ref: fluid/layers/tensor.py
    create_global_var): of the current Program in static mode, else a
    tensor on the default device (the CPU with `force_cpu`)."""
    from ..core.mode import in_static_mode
    if in_static_mode():
        from ..static import create_global_var as static_global
        return static_global(shape, value, dtype, persistable, force_cpu,
                             name)
    return _ops.full(shape, value, dtype) if not force_cpu else \
        torch.full(tuple(shape), value,
                   dtype=dtype_mod.convert_dtype(dtype))


# ---- reference submodule attribute surface (ref: fluid/layers/__init__
# binds nn/tensor/ops/control_flow/io/detection/... as attributes; user
# code reaches fluid.layers.nn.relu, fluid.layers.tensor.concat, ...).
# The rebuild keeps ONE flat namespace, so each submodule name points at
# it — a superset of every reference submodule's names.
import sys as _sys

nn = _sys.modules[__name__]
ops = _sys.modules[__name__]
tensor = _sys.modules[__name__]
control_flow = _sys.modules[__name__]
device = _sys.modules[__name__]
io = _sys.modules[__name__]
detection = _sys.modules[__name__]
metric_op = _sys.modules[__name__]


class math_op_patch:  # ref: fluid/layers/math_op_patch.py
    @staticmethod
    def monkey_patch_variable():
        """The tensor is torch.Tensor: its operators need no patching."""
