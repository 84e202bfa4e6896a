"""paddle.static.nn: the fluid-style layer functions of a static Program,
the port of `paddle_tpu/static/nn.py` (ref: python/paddle/fluid/layers/
nn.py). Each function creates its parameters in the current Program (their
initializers run in the startup Program) and records its compute as the
port's eager ops on the Program's Variables. A parameter takes the
input's floating dtype (float32 for integer inputs), so a float64 Program
trains float64 weights; the reference's are float32 always.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from .. import ops
from ..core import unique_name
from ..core.param_attr import ParamAttr
from ..nn import initializer as I
from ..ops.control import case, cond, switch_case, while_loop  # noqa: F401
from .program import default_main_program, record


def _dtype(x):
    return x.dtype if x.is_floating_point() else torch.float32


def _create_param(shape, dtype, attr, is_bias=False, default_init=None):
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_init or (
        I.Constant(0.0) if is_bias else I.XavierUniform())
    block = default_main_program().global_block()
    v = block.create_parameter(tuple(int(s) for s in shape), dtype,
                               name=attr.name, initializer=init,
                               trainable=attr.trainable)
    v.optimize_attr = {"learning_rate": attr.learning_rate}
    v.regularizer = attr.regularizer
    v.stop_gradient = not attr.trainable
    return v


def _act(out, act):
    return getattr(ops, act)(out) if act else out


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None, param_attr=None, act=None):
    # `param_attr` / `act` are the fluid 1.x spellings
    weight_attr = weight_attr or param_attr
    activation = activation or act
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = _create_param((in_dim, size), _dtype(x), weight_attr)
    b = _create_param((size,), _dtype(x), bias_attr, is_bias=True)
    return _act(record(_fc, (x, w, b, num_flatten_dims), name="fc"),
                activation)


def _fc(x, w, b, num_flatten_dims):
    if x.dim() > num_flatten_dims + 1 and num_flatten_dims > 0:
        x = ops.flatten(x, num_flatten_dims, -1)
    return ops.linear(x, w, b)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None, use_cudnn=True):
    ksize = _pair(filter_size)
    cin = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    fan_in = (cin // groups) * int(np.prod(ksize))
    w = _create_param((num_filters, cin // groups) + ksize, _dtype(input),
                      param_attr,
                      default_init=I.Normal(0.0, (2.0 / fan_in) ** 0.5))
    b = _create_param((num_filters,), _dtype(input), bias_attr, is_bias=True)
    return _act(record(ops.conv2d, (input, w, b, stride, padding, dilation,
                                    groups, data_format), name="conv2d"),
                act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           data_format="NCHW", name=None, use_cudnn=True, exclusive=True):
    if global_pooling:
        fn = ops.adaptive_avg_pool2d if pool_type == "avg" \
            else ops.adaptive_max_pool2d
        return record(fn, (input, 1), name="pool2d")
    if pool_type == "max":
        return record(ops.max_pool2d, (input, pool_size, pool_stride,
                                       pool_padding, ceil_mode, data_format),
                      name="pool2d")
    return record(ops.avg_pool2d, (input, pool_size, pool_stride,
                                   pool_padding, ceil_mode, exclusive, None,
                                   data_format), name="pool2d")


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,  # noqa: A002
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, use_global_stats=False, name=None, **kw):
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dt = _dtype(input)
    scale = _create_param((c,), dt, param_attr, default_init=I.Constant(1.0))
    bias = _create_param((c,), dt, bias_attr, is_bias=True)
    mean = _create_param((c,), dt, ParamAttr(
        name=unique_name.generate("bn_mean"), trainable=False),
        default_init=I.Constant(0.0))
    var = _create_param((c,), dt, ParamAttr(
        name=unique_name.generate("bn_var"), trainable=False),
        default_init=I.Constant(1.0))
    out, _, _ = record(ops.batch_norm, (input, mean, var, scale, bias),
                       dict(training=not is_test, momentum=momentum,
                            epsilon=epsilon, data_format=data_layout,
                            use_global_stats=use_global_stats),
                       name="batch_norm")
    return _act(out, act)


def embedding(input, size, padding_idx=None, param_attr=None,  # noqa: A002
              dtype="float32", is_sparse=False, name=None):
    w = _create_param(tuple(size), dtype, param_attr,
                      default_init=I.Normal(0.0, 1.0))
    return record(ops.embedding, (input, w), dict(padding_idx=padding_idx),
                  name="embedding")


def dropout(x, dropout_prob=0.5, is_test=False, name=None, **kw):
    return record(ops.dropout, (x,), dict(p=dropout_prob,
                                          training=not is_test),
                  name="dropout")


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    norm_shape = tuple(input.shape[begin_norm_axis:])
    dt = _dtype(input)
    w = _create_param(norm_shape, dt, param_attr,
                      default_init=I.Constant(1.0)) if scale else None
    b = _create_param(norm_shape, dt, bias_attr, is_bias=True) \
        if shift else None
    out = record(ops.layer_norm, (input, w, b, epsilon),
                 dict(normalized_ndim=len(norm_shape)), name="layer_norm")
    return _act(out, act)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """ref: fluid/layers/tensor.py create_parameter."""
    attr = ParamAttr._to_attr(attr) if attr is not None \
        else ParamAttr(name=name)
    return _create_param(tuple(shape), dtype, attr, is_bias=is_bias,
                         default_init=default_initializer)


def prelu(x, mode="all", param_attr=None, name=None):
    """ref: fluid/layers/nn.py prelu — alpha's shape by mode."""
    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        shape = (x.shape[1],)
    else:  # element
        shape = tuple(x.shape[1:])
    a = _create_param(shape, _dtype(x), param_attr,
                      default_init=I.Constant(0.25))
    return record(ops.prelu, (x, a), name="prelu")


def _affine(input, param_attr, bias_attr):
    c = input.shape[1]
    dt = _dtype(input)
    w = _create_param((c,), dt, param_attr, default_init=I.Constant(1.0)) \
        if param_attr is not False else None
    b = _create_param((c,), dt, bias_attr, is_bias=True) \
        if bias_attr is not False else None
    return w, b


def instance_norm(input, epsilon=1e-5, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    w, b = _affine(input, param_attr, bias_attr)
    return record(ops.instance_norm, (input, w, b, epsilon),
                  name="instance_norm")


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    w, b = _affine(input, param_attr, bias_attr)
    return _act(record(ops.group_norm, (input, groups, w, b, epsilon),
                       name="group_norm"), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """ref: fluid/layers/nn.py spectral_norm — power iteration from a
    persistable u vector."""
    w = weight
    h = w.shape[dim]
    u = _create_param((h,), _dtype(w), ParamAttr(name=None),
                      default_init=I.Normal(0.0, 1.0))
    wm = ops.reshape(ops.transpose(
        w, [dim] + [i for i in range(len(w.shape)) if i != dim]), [h, -1])
    uv, vv = u, None
    for _ in range(max(1, power_iters)):
        vv = ops.matmul(uv, wm)
        vv = vv / (ops.norm(vv) + eps)
        uv = ops.matmul(wm, vv)
        uv = uv / (ops.norm(uv) + eps)
    sigma = ops.sum(uv * ops.matmul(wm, vv))
    return w / sigma


def _conv_nd(conv, input, num_filters, filter_size, stride, padding,
             dilation, groups, param_attr, bias_attr, act, nd, transpose):
    cin = input.shape[1]
    g = groups or 1
    fs = _pair(filter_size, nd)
    wshape = ((cin, num_filters // g) if transpose
              else (num_filters, cin // g)) + fs
    w = _create_param(wshape, _dtype(input), param_attr)
    b = _create_param((num_filters,), _dtype(input), bias_attr, is_bias=True)
    out = record(conv, (input, w, b), dict(stride=stride, padding=padding,
                                           dilation=dilation, groups=g),
                 name=conv.__name__)
    return _act(out, act)


def conv2d_transpose(input, num_filters, filter_size=None,  # noqa: A002
                     output_size=None, stride=1, padding=0, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None, data_format="NCHW"):
    return _conv_nd(ops.conv2d_transpose, input, num_filters, filter_size,
                    stride, padding, dilation, groups, param_attr, bias_attr,
                    act, 2, True)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
           name=None, data_format="NCDHW"):
    return _conv_nd(ops.conv3d, input, num_filters, filter_size, stride,
                    padding, dilation, groups, param_attr, bias_attr, act, 3,
                    False)


def conv3d_transpose(input, num_filters, filter_size=None,  # noqa: A002
                     output_size=None, stride=1, padding=0, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None, data_format="NCDHW"):
    return _conv_nd(ops.conv3d_transpose, input, num_filters, filter_size,
                    stride, padding, dilation, groups, param_attr, bias_attr,
                    act, 3, True)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x^T W_k y + b_k (ref: fluid/layers/nn.py
    bilinear_tensor_product)."""
    w = _create_param((size, x.shape[-1], y.shape[-1]), _dtype(x),
                      param_attr)
    b = _create_param((size,), _dtype(x), bias_attr, is_bias=True)
    out = ops.einsum("bi,kij,bj->bk", x, w, y)
    if b is not None:
        out = out + b
    return _act(out, act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,  # noqa: A002
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              summary_decay_rate=0.9999999, sync_stats=False,
              enable_scale_and_shift=False):
    """ref: fluid/layers/nn.py data_norm — normalization by accumulated
    batch statistics (batch_size / batch_sum / batch_square_sum
    persistables)."""
    c = input.shape[-1] if data_layout == "NHWC" else input.shape[1]
    dt = _dtype(input)
    bsize = _create_param((c,), dt, ParamAttr(name=None),
                          default_init=I.Constant(1e4))
    bsum = _create_param((c,), dt, ParamAttr(name=None),
                         default_init=I.Constant(0.0))
    bsqs = _create_param((c,), dt, ParamAttr(name=None),
                         default_init=I.Constant(1e4))
    mean = bsum / bsize
    scale = ops.rsqrt(bsqs / bsize + epsilon)
    shape = [1, -1] + [1] * (len(input.shape) - 2) \
        if data_layout == "NCHW" else [1] * (len(input.shape) - 1) + [-1]
    out = (input - ops.reshape(mean, shape)) * ops.reshape(scale, shape)
    return _act(out, act)


def row_conv(input, future_context_size, param_attr=None,  # noqa: A002
             act=None):
    """Lookahead row convolution (ref: row_conv_op): out[t] = sum over
    i = 0..F of w[i] * x[t + i], dense [B, T, D], zeros past the end."""
    f = future_context_size + 1
    w = _create_param((f, input.shape[-1]), _dtype(input), param_attr)
    return _act(record(_row_conv, (input, w), name="row_conv"), act)


def _row_conv(x, w):
    t = x.shape[1]
    xp = TF.pad(x, (0, 0, 0, w.shape[0] - 1))
    out = xp[:, 0:t] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xp[:, i:i + t] * w[i]
    return out


class _HostFunc(torch.autograd.Function):
    """A host Python function inside the graph; its backward calls
    `backward_func` (the reference's py_func grad op), whose outputs are
    taken positionally for the floating inputs."""

    @staticmethod
    def forward(ctx, func, backward_func, out_specs, *xs):
        ctx.backward_func = backward_func
        ctx.save_for_backward(*xs)
        r = func(*[x.detach().cpu().numpy() for x in xs])
        rs = r if isinstance(r, (list, tuple)) else [r]
        return tuple(torch.as_tensor(np.asarray(v, dtype=d), device=xs[0]
                                     .device).reshape(s)
                     for v, (s, d) in zip(rs, out_specs))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        if ctx.backward_func is None:
            return (None, None, None) + (None,) * len(xs)
        arrs = [x.detach().cpu().numpy() for x in xs] + \
            [g.detach().cpu().numpy() for g in gs]
        g = ctx.backward_func(*arrs)
        gl = list(g) if isinstance(g, (list, tuple)) else [g]
        floats = [x.is_floating_point() for x in xs]
        if len(gl) == len(xs):
            gl = [v for v, f in zip(gl, floats) if f]
        it = iter(gl)
        out = [torch.as_tensor(np.asarray(next(it)), dtype=x.dtype,
                               device=x.device).reshape(x.shape)
               if f else None for x, f in zip(xs, floats)]
        return (None, None, None, *out)


def _spec(o):
    dt = o.dtype if isinstance(o.dtype, np.dtype) else \
        np.dtype(str(o.dtype).replace("torch.", ""))
    return tuple(int(s) for s in o.shape), dt


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """ref: fluid/layers/nn.py py_func — a host Python function over numpy
    arrays inside the graph. `out` gives the results' shapes and dtypes
    (tensors, or objects with .shape and .dtype); `backward_func(*(inputs
    + output gradients)) -> input gradients` gives it a gradient (integer
    inputs take none). In a static Program it is one recorded op."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    specs = tuple(_spec(o) for o in outs)

    def call(*ts):
        return _HostFunc.apply(func, backward_func, specs, *ts)

    def infer(*ts):
        return tuple(torch.empty(s, dtype=torch.from_numpy(
            np.zeros(0, d)).dtype, device="meta") for s, d in specs)

    res = record(call, xs, infer=infer, name="py_func")
    res = list(res)
    return res if isinstance(out, (list, tuple)) else res[0]


def crf_decoding(input, param_attr=None, length=None,  # noqa: A002
                 label=None):
    """Viterbi decode over a linear-chain CRF (ref: crf_decoding_op):
    unary potentials [B, T, N], transitions [N + 2, N] with the start and
    stop rows at 0 and 1; [B, T] int32 tags, ties to the first index."""
    n = input.shape[-1]
    w = _create_param((n + 2, n), _dtype(input), param_attr)
    return record(_viterbi, (input, w), name="crf_decoding")


def _viterbi(emis, w):
    start, stop, trans = w[0], w[1], w[2:]
    score = start + emis[:, 0]
    backs = []
    for i in range(1, emis.shape[1]):
        cand = score[:, :, None] + trans
        backs.append(cand.argmax(dim=1))
        score = cand.amax(dim=1) + emis[:, i]
    cur = (score + stop).argmax(dim=1)
    path = [cur]
    for back in reversed(backs):
        cur = torch.gather(back, 1, cur[:, None])[:, 0]
        path.append(cur)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=5, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation (ref: nce_op; the reference's static
    form): a logistic loss over the label's logit and `num_neg_samples`
    uniform negatives a row, drawn afresh at every run. [N, 1]."""
    w = _create_param((num_total_classes, input.shape[-1]), _dtype(input),
                      param_attr)
    b = _create_param((num_total_classes,), _dtype(input), bias_attr,
                      is_bias=True)
    return record(_nce, (input, label, w, b, num_total_classes,
                         num_neg_samples), name="nce")


def _nce(x, label, w, b, num_total_classes, num_neg_samples):
    from ..ops.nn_ops import _gen
    lv = label.reshape(-1).long()
    negs = lv.new_empty((x.shape[0], num_neg_samples)).random_(
        0, num_total_classes, generator=_gen(x, None))
    pos_logit = (x * w[lv]).sum(-1) + b[lv]
    neg_logit = torch.einsum("bd,bnd->bn", x, w[negs]) + b[negs]
    loss = TF.softplus(-pos_logit) + TF.softplus(neg_logit).sum(-1)
    return loss[:, None]


def multi_box_head(inputs, image, base_size, num_classes,  # noqa: A002
                   aspect_ratios, min_ratio=None, max_ratio=None,
                   min_sizes=None, max_sizes=None, steps=None, step_w=None,
                   step_h=None, offset=0.5, variance=(0.1, 0.1, 0.2, 0.2),
                   flip=True, clip=False, kernel_size=1, pad=0, stride=1,
                   name=None, min_max_aspect_ratios_order=False):
    """SSD's detection head (ref: fluid/layers/detection.py
    multi_box_head): per feature map a conv predicts loc and conf and
    prior_box gives the anchors; the outputs are concatenated over the
    maps."""
    from ..nn.functional.detection import prior_box as _prior_box

    if min_sizes is None:  # the reference's ratio interpolation
        num_layer = len(inputs)
        min_ratio = min_ratio or 20
        max_ratio = max_ratio or 90
        step = int((max_ratio - min_ratio) / max(1, (num_layer - 2)))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[: num_layer - 1]
        max_sizes = [base_size * 0.2] + max_sizes[: num_layer - 1]

    dev = image.device
    locs, confs, boxes, vars_ = [], [], [], []
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        mn = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) \
            else [min_sizes[i]]
        mx = [max_sizes[i]] if max_sizes and max_sizes[i] else None
        # prior_box reads only the two shapes: real tensors of them
        box, var = _prior_box(
            torch.empty(tuple(feat.shape), device=dev),
            torch.empty(tuple(image.shape), device=dev), mn, mx, ar,
            variance, flip, clip, offset=offset)
        num_priors = int(np.prod(box.shape[:-1])) // int(
            np.prod(feat.shape[2:]))
        loc = conv2d(feat, num_priors * 4, kernel_size, stride=stride,
                     padding=pad)
        conf = conv2d(feat, num_priors * num_classes, kernel_size,
                      stride=stride, padding=pad)
        locs.append(record(_nhwc_rows, (loc, 4), name="mbox_loc"))
        confs.append(record(_nhwc_rows, (conf, num_classes),
                            name="mbox_conf"))
        boxes.append(ops.reshape(box, [-1, 4]))
        vars_.append(ops.reshape(var, [-1, 4]))
    return (ops.concat(locs, 1), ops.concat(confs, 1), ops.concat(boxes, 0),
            ops.concat(vars_, 0))


def _nhwc_rows(t, width):
    """[B, C, H, W] -> [B, H * W * C / width, width] in NHWC order."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, width)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None,
                  name=None):
    """Deformable conv v2 (ref: deformable_conv_op): each kernel tap
    samples the input bilinearly at its offset (zeros outside), scaled by
    the mask, then one product with the weight, plus the bias."""
    kh, kw = _pair(filter_size)
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    wgt = _create_param((num_filters, x.shape[1] // (groups or 1), kh, kw),
                        _dtype(x), param_attr)
    b = _create_param((num_filters,), _dtype(x), bias_attr, is_bias=True)
    return record(_deform_conv, (x, offset, mask, wgt, b, st, pd, dl,
                                 deformable_groups), name="deform_conv2d")


def _deform_conv(x, offset, mask, wgt, b, st, pd, dl, deformable_groups):
    n, c, h, wd = x.shape
    kh, kw = wgt.shape[2], wgt.shape[3]
    ho = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    wo = (wd + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * st[0] - pd[0])[
        :, None, None, None] + (torch.arange(kh, device=dev) * dl[0])[
        None, None, :, None]
    base_x = (torch.arange(wo, device=dev) * st[1] - pd[1])[
        None, :, None, None] + (torch.arange(kw, device=dev) * dl[1])[
        None, None, None, :]
    off = offset.reshape(n, deformable_groups, kh, kw, 2, ho, wo)
    py = base_y[None].to(x.dtype) + off[:, 0, :, :, 0].permute(0, 3, 4, 1, 2)
    px = base_x[None].to(x.dtype) + off[:, 0, :, :, 1].permute(0, 3, 4, 1, 2)
    y0 = torch.floor(py).long()
    x0 = torch.floor(px).long()
    wy = py - y0
    wx = px - x0
    img = x.permute(0, 2, 3, 1)  # [N, H, W, C]
    nidx = torch.arange(n, device=dev)[:, None, None, None, None]

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < wd)
        g = img[nidx, yy.clamp(0, h - 1), xx.clamp(0, wd - 1)]
        return torch.where(valid[..., None], g, 0.0)

    val = (sample(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + sample(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + sample(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + sample(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    if mask is not None:
        m = mask.reshape(n, deformable_groups, kh, kw, ho, wo)[:, 0]
        val = val * m.permute(0, 3, 4, 1, 2)[..., None]
    out = torch.einsum("nhwklc,ockl->nohw", val, wgt)
    return out if b is None else out + b.reshape(1, -1, 1, 1)


__all__ = ["fc", "conv2d", "pool2d", "batch_norm", "embedding", "dropout",
           "layer_norm", "cond", "while_loop", "case", "switch_case",
           "create_parameter", "prelu", "instance_norm", "group_norm",
           "spectral_norm", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "bilinear_tensor_product", "data_norm", "row_conv", "py_func",
           "crf_decoding", "nce", "multi_box_head", "deform_conv2d"]
