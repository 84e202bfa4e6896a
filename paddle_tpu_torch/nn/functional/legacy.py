"""The fluid 1.x functional layers the 2.0 `nn.functional` namespace
keeps: the port of `paddle_tpu/nn/functional/legacy.py`.

Every op takes and returns `torch.Tensor`s, runs on its input's device
and is differentiable through torch's autograd. The LoD-era ops take
dense padded tensors (the layout of `sequence.py`).

Parameters follow the reference's contract (`LegacyParamStore`): an
unnamed call (`fc`, `nce`, `row_conv`, `deformable_conv`,
`bilinear_tensor_product`, the RNN layer functions) makes fresh parameters every
time; a named call (`name=` or `ParamAttr(name=...)`) makes them once in
the process-wide store, on the input's device, and reuses them, so
`legacy_param_store().parameters()` can be handed to an optimizer.
Buffers that persist across calls — `center_loss`'s centers, the CRF
transitions — live in the store too. Random draws (`nce`'s negatives,
`random_crop`'s offsets) come from the port's generator of the input's
device, or from `generator=`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ... import ops
from ...device import device_guard


class LegacyParamStore:
    """Name-keyed registry behind the fluid 1.x eager shims: named
    parameters (`parameter`), named layers (`layer`) and persistent
    buffers (`buffer` / `set_buffer`)."""

    def __init__(self):
        self._params = {}   # name -> Parameter
        self._layers = {}   # name -> nn.Layer
        self._buffers = {}  # name -> tensor

    def parameter(self, name, shape, dtype="float32", initializer=None,
                  device=None):
        p = self._params.get(name)
        if p is not None:
            if tuple(p.shape) != tuple(shape):
                raise ValueError(
                    f"legacy parameter {name!r} exists with shape "
                    f"{tuple(p.shape)}, requested {tuple(shape)}")
            return p
        from ...core.tensor import make_parameter
        from .. import initializer as I
        init = initializer or I.XavierUniform()
        p = make_parameter(init(tuple(shape), dtype, device=device),
                           name=name)
        self._params[name] = p
        return p

    def layer(self, name, factory):
        lyr = self._layers.get(name)
        if lyr is None:
            lyr = factory()
            self._layers[name] = lyr
        return lyr

    def buffer(self, name, default_fn):
        b = self._buffers.get(name)
        if b is None:
            b = self._buffers[name] = default_fn()
        return b

    def set_buffer(self, name, value):
        self._buffers[name] = value

    def parameters(self):
        out = list(self._params.values())
        for lyr in self._layers.values():
            out.extend(lyr.parameters())
        return out

    def state_dict(self):
        sd = dict(self._params)
        for lname, lyr in self._layers.items():
            for k, v in lyr.state_dict().items():
                sd[f"{lname}.{k}"] = v
        for k, b in self._buffers.items():
            sd[f"buffer/{k}"] = b
        return sd

    def clear(self):
        self._params.clear()
        self._layers.clear()
        self._buffers.clear()


_store = LegacyParamStore()


def legacy_param_store():
    """The process-wide store of the parameters made by named fluid 1.x
    shim calls (`fc(name=...)` etc.). Pass
    `legacy_param_store().parameters()` to an optimizer to train them."""
    return _store


def _attr_name(name, attr):
    if name:
        return name
    return getattr(attr, "name", None) if attr is not None else None


def _act(out, act):
    return getattr(ops, act)(out) if act else out


def _fresh(init, shape, device):
    """An unnamed call's parameter: fresh, trainable, on `device`."""
    from ...core.tensor import make_parameter
    return make_parameter(init(tuple(shape), "float32", device=device))


# ---- dense / elementwise ----

def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """1.x fully connected: the leading `num_flatten_dims` dims kept, the
    rest flattened, then projected to `size`."""
    from .. import Linear
    lead = tuple(x.shape[:num_flatten_dims])
    flat = x.reshape(math.prod(lead), -1)

    def factory():
        with device_guard(x.device):
            return Linear(flat.shape[1], size, weight_attr=weight_attr,
                          bias_attr=bias_attr)

    pname = _attr_name(name, weight_attr)
    layer = _store.layer(f"fc/{pname}", factory) if pname else factory()
    got = tuple(layer.weight.shape)
    if got != (flat.shape[1], size):
        raise ValueError(
            f"fc name {pname!r} exists with weight shape {got}, but this "
            f"call needs {(flat.shape[1], size)} — use a different name")
    out = layer(flat).reshape(lead + (size,))
    return _act(out, activation)


def erf(x, name=None):
    return torch.erf(x.float()).to(x.dtype)


def soft_relu(x, threshold=40.0, name=None):
    return torch.log1p(torch.exp(x.clamp(-threshold, threshold)))


def assign(x, output=None, name=None):
    v = x.clone() if torch.is_tensor(x) else torch.as_tensor(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(v)
        return output
    return v


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    """Per-row smooth-L1 summed over the trailing dims: [N, 1]."""
    d = x - y
    if inside_weight is not None:
        d = d * inside_weight
    s2 = sigma * sigma
    ad = d.abs()
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if outside_weight is not None:
        loss = loss * outside_weight
    return loss.reshape(loss.shape[0], -1).sum(dim=1, keepdim=True)


def pad2d(x, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    """paddings (top, bottom, left, right) of the spatial dims; mode
    constant, reflect or edge."""
    t, b, l, r = paddings
    nhwc = data_format != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if mode == "constant":
        out = TF.pad(x, (l, r, t, b), value=pad_value)
    else:
        out = TF.pad(x, (l, r, t, b),
                     mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return out.permute(0, 2, 3, 1) if nhwc else out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """y padded at the end of each dim to x's shape."""
    pads = []
    for xd, yd in zip(reversed(x.shape), reversed(y.shape)):
        pads += [0, xd - yd]
    return TF.pad(y, pads, value=pad_value)


def affine_channel(x, scale=None, bias=None, data_format="NCHW", act=None,
                   name=None):
    shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
    out = x
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return _act(out, act)


def data_norm(input, act=None, epsilon=1e-5, name=None, **kw):  # noqa: A002
    """Normalization by the batch's mean and (biased) variance."""
    mean = input.mean(dim=0, keepdim=True)
    var = input.var(dim=0, keepdim=True, unbiased=False)
    return _act((input - mean) / torch.sqrt(var + epsilon), act)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):  # noqa: A002
    """alpha · x + beta · the sinusoid table [sin | cos] over [B, T, C]."""
    b, t, c = input.shape
    dev = input.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(c // 2, dtype=torch.float32, device=dev)[None, :]
    freq = pos / torch.pow(torch.tensor(10000.0, device=dev), 2.0 * i / c)
    pe = torch.cat([torch.sin(freq), torch.cos(freq)], dim=1)
    if pe.shape[1] < c:
        pe = TF.pad(pe, (0, c - pe.shape[1]))
    return alpha * input + beta * pe[None].to(input.dtype)


def space_to_depth(x, blocksize, name=None):
    n, c, h, w = x.shape
    bs = blocksize
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


def shuffle_channel(x, group, name=None):
    n, c, h, w = x.shape
    return x.reshape(n, group, c // group, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


def similarity_focus(input, axis, indexes, name=None):  # noqa: A002
    """Mask of the positions equal to each selected slice's maximum,
    broadcast over the channels."""
    n, c, h, w = input.shape
    sel = input[:, list(indexes)] if axis == 1 else input
    m = torch.zeros(n, h, w, dtype=torch.bool, device=input.device)
    for k in range(len(indexes)):
        sl = sel[:, k]
        m = m | (sl == sl.amax(dim=(1, 2), keepdim=True))
    return m[:, None].expand(input.shape).to(input.dtype)


def fsp_matrix(x, y):
    """[N, C1, H, W] x [N, C2, H, W] -> [N, C1, C2], over H·W."""
    n, c1, h, w = x.shape
    a = x.reshape(n, c1, h * w)
    b = y.reshape(n, y.shape[1], h * w)
    return torch.einsum("nax,nbx->nab", a, b) / (h * w)


def hash(input, hash_size, num_hash=1, name=None):  # noqa: A002
    """Deterministic ids in [0, hash_size): the reference's multiplicative
    mix on the ids' low 32 bits, in int64 arithmetic (kept to 32 bits)."""
    m32 = 0xFFFFFFFF
    xv = input.to(torch.int64) & m32
    outs = []
    for i in range(num_hash):
        mixed = (xv * 2654435761 + ((i * 0x9E3779B9) & m32)) & m32
        mixed = mixed ^ (mixed >> 16)
        outs.append(mixed % hash_size)
    return torch.stack(outs, dim=-1).reshape(tuple(input.shape[:-1])
                                             + (-1,))


def im2sequence(input, filter_size=1, stride=1, padding=0,  # noqa: A002
                input_image_size=None, out_stride=1, name=None):
    """Image patches as sequence steps: [N, L, C·kh·kw]."""
    fs = [filter_size] * 2 if isinstance(filter_size, int) else filter_size
    st = [stride] * 2 if isinstance(stride, int) else stride
    pd = [padding] * 4 if isinstance(padding, int) else padding
    cols = ops.unfold(input, fs, strides=st,
                      paddings=pd[:2] if len(pd) == 4 else pd)
    return cols.transpose(1, 2)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A host counter: [begin], then + step on each call (an int64 tensor
    on the CPU)."""
    key = counter_name or "@STEP_COUNTER@"
    c = autoincreased_step_counter._counters.get(key, begin - step) + step
    autoincreased_step_counter._counters[key] = c
    return torch.tensor([c], dtype=torch.int64)


autoincreased_step_counter._counters = {}


def continuous_value_model(input, cvm, use_cvm=True):  # noqa: A002
    return input if use_cvm else input[:, 2:]


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    """Rows whose tag is in filter_tag kept (the rest set to
    out_val_if_empty); also the kept rows' indices, in order and padded
    with -1, and the keep mask — static shapes, no host sync."""
    tags = ins_tag.reshape(-1)
    keep = torch.isin(tags, torch.as_tensor(filter_tag, device=tags.device))
    out = torch.where(keep.reshape((-1,) + (1,) * (ins.dim() - 1)), ins,
                      torch.as_tensor(out_val_if_empty, dtype=ins.dtype,
                                      device=ins.device))
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    idx = torch.where(keep[order], order, torch.full_like(order, -1))
    return out, idx, keep.to(torch.int64)


def polygon_box_transform(input, name=None):  # noqa: A002
    """Offset map [N, 8k, H, W] to absolute quad coordinates."""
    n, c, h, w = input.shape
    dev = input.device
    xs = torch.arange(w, dtype=input.dtype, device=dev)[None, None, None, :]
    ys = torch.arange(h, dtype=input.dtype, device=dev)[None, None, :, None]
    is_x = (torch.arange(c, device=dev) % 2 == 0).reshape(1, c, 1, 1)
    return torch.where(is_x, xs * 4 - input, ys * 4 - input)


# ---- tensor arrays (Python lists) ----

def create_array(dtype="float32"):
    return []


def _index(i):
    return int(i.reshape(-1)[0]) if torch.is_tensor(i) else int(i)


def array_write(x, i, array=None):
    if array is None:
        array = []
    idx = _index(i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array, i):
    return array[_index(i)]


def array_length(array):
    return torch.tensor([len(array)], dtype=torch.int64)


def tensor_array_to_tensor(input, axis=1, use_stack=False):  # noqa: A002
    vals = [x for x in input if x is not None]
    out = torch.stack(vals, dim=axis) if use_stack \
        else torch.cat(vals, dim=axis)
    sizes = torch.tensor([v.shape[axis] for v in vals], dtype=torch.int32)
    return out, sizes


# ---- LoD no-ops (dense tensors carry no LoD) ----

def lod_reset(x, y=None, target_lod=None):
    return x


def lod_append(x, level):
    return x


def merge_selected_rows(x, name=None):
    return x


def reorder_lod_tensor_by_rank(x, rank_table):
    return x


# ---- the resize family (ops.interpolate: jax.image.resize's arithmetic) ----

def image_resize(input, out_shape=None, scale=None,  # noqa: A002
                 resample="BILINEAR", align_corners=True, align_mode=1,
                 data_format="NCHW", name=None, **kw):
    return ops.interpolate(input, size=out_shape, scale_factor=scale,
                           mode=resample.lower(),
                           align_corners=align_corners,
                           data_format=data_format)


def resize_bilinear(input, out_shape=None, scale=None,  # noqa: A002
                    align_corners=True, align_mode=1, data_format="NCHW",
                    name=None):
    return image_resize(input, out_shape, scale, "BILINEAR", align_corners,
                        align_mode, data_format)


def resize_nearest(input, out_shape=None, scale=None,  # noqa: A002
                   align_corners=True, data_format="NCHW", name=None):
    return image_resize(input, out_shape, scale, "NEAREST", align_corners,
                        1, data_format)


def resize_trilinear(input, out_shape=None, scale=None,  # noqa: A002
                     align_corners=True, align_mode=1, data_format="NCDHW",
                     name=None):
    return ops.interpolate(input, size=out_shape, scale_factor=scale,
                           mode="trilinear", align_corners=align_corners,
                           data_format=data_format)


def image_resize_short(input, out_short_len, resample="BILINEAR"):  # noqa: A002
    h, w = input.shape[2], input.shape[3]
    scale = out_short_len / min(h, w)
    return image_resize(input, [int(round(h * scale)), int(round(w * scale))],
                        None, resample)


def random_crop(x, shape, seed=None, generator=None):
    """A window of `shape` over x's trailing dims at a random offset (from
    `generator`, a generator seeded with `seed`, or the port's generator
    of x's device)."""
    from ...core import rng
    if generator is None:
        generator = rng.generator(x.device) if seed is None else \
            torch.Generator(device=x.device).manual_seed(int(seed))
    lead = x.dim() - len(shape)
    out = x
    for d, (dim, target) in enumerate(zip(x.shape[lead:], shape)):
        start = int(torch.randint(0, dim - target + 1, (1,),
                                  generator=generator,
                                  device=generator.device))
        out = out.narrow(lead + d, start, target)
    return out


# ---- pooling, 1.x names ----

def _pool(x, dims, pool_size, pool_type, pool_stride, pool_padding,
          global_pooling, ceil_mode, pool_max, pool_avg):
    if global_pooling:
        return x.mean(dim=dims, keepdim=True) if pool_type == "avg" \
            else x.amax(dim=dims, keepdim=True)
    f = pool_max if pool_type == "max" else pool_avg
    return f(x, pool_size, stride=pool_stride, padding=pool_padding,
             ceil_mode=ceil_mode)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    """1.x pooling over [N, C, H, W]: global mean / max, or
    max_pool2d / avg_pool2d with the given window."""
    return _pool(input, (2, 3), pool_size, pool_type, pool_stride,
                 pool_padding, global_pooling, ceil_mode, ops.max_pool2d,
                 ops.avg_pool2d)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCDHW", name=None):
    return _pool(input, (2, 3, 4), pool_size, pool_type, pool_stride,
                 pool_padding, global_pooling, ceil_mode, ops.max_pool3d,
                 ops.avg_pool3d)


# ---- RNN layer functions (fresh layers of `nn.layer.rnn` on the input's device) ----

def _on(x, factory):
    with device_guard(x.device):
        return factory()


def birnn(cell_fw, cell_bw, inputs, initial_states=None, sequence_length=None,
          time_major=False, **kw):
    from ..layer.rnn import RNN
    fw = RNN(cell_fw, time_major=time_major)
    bw = RNN(cell_bw, time_major=time_major, is_reverse=True)
    s_fw, s_bw = initial_states if initial_states is not None \
        else (None, None)
    out_fw, st_fw = fw(inputs, s_fw, sequence_length)
    out_bw, st_bw = bw(inputs, s_bw, sequence_length)
    return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


def lstm(input, init_h, init_c, max_len=None, hidden_size=None,  # noqa: A002
         num_layers=1, dropout_prob=0.0, is_bidirec=False, **kw):
    from ..layer.rnn import LSTM
    hidden_size = hidden_size or init_h.shape[-1]
    layer = _on(input, lambda: LSTM(
        input.shape[-1], hidden_size, num_layers=num_layers,
        direction="bidirect" if is_bidirec else "forward"))
    out, (h, c) = layer(input, (init_h, init_c))
    return out, h, c


def dynamic_lstm(input, size, h_0=None, c_0=None, **kw):  # noqa: A002
    from ..layer.rnn import LSTM
    layer = _on(input, lambda: LSTM(input.shape[-1], size // 4))
    out, (h, c) = layer(input, None if h_0 is None else (h_0, c_0))
    return out, c


def dynamic_lstmp(input, size, proj_size, **kw):  # noqa: A002
    out, c = dynamic_lstm(input, size, **kw)
    return fc(out, proj_size, num_flatten_dims=2), c


def dynamic_gru(input, size, h_0=None, **kw):  # noqa: A002
    from ..layer.rnn import GRU
    layer = _on(input, lambda: GRU(input.shape[-1], size))
    out, h = layer(input, h_0)
    return out


def gru_unit(input, hidden, size, **kw):  # noqa: A002
    from ..layer.rnn import GRUCell
    cell = _on(input, lambda: GRUCell(input.shape[-1], size // 3))
    h, _ = cell(input, hidden)
    return h, h, h


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, **kw):
    from ..layer.rnn import LSTMCell
    cell = _on(x_t, lambda: LSTMCell(x_t.shape[-1],
                                     hidden_t_prev.shape[-1]))
    h, (h2, c) = cell(x_t, (hidden_t_prev, cell_t_prev))
    return h, c


def row_conv(input, future_context_size, param_attr=None, act=None):  # noqa: A002
    """Lookahead row convolution: step t mixes steps t .. t + future
    with per-channel weights [future + 1, C] (zeros past the end)."""
    from .. import initializer as I
    c = input.shape[-1]
    shape = (future_context_size + 1, c)
    pname = _attr_name(None, param_attr)
    w = _store.parameter(f"row_conv/{pname}", shape, device=input.device) \
        if pname else _fresh(I.XavierUniform(), shape, input.device)
    t = input.shape[1]
    out = torch.zeros_like(input)
    for i in range(future_context_size + 1):
        rolled = torch.roll(input, -i, dims=1)
        valid = (torch.arange(t, device=input.device) + i < t)[None, :, None]
        out = out + torch.where(valid, rolled, 0.0) * w[i][None, None, :]
    return _act(out, act)


def gather_tree(ids, parents):
    """Trace beam-search parent pointers back into whole sequences:
    ids, parents [T, B, beam] -> [T, B, beam]."""
    par = parents.to(torch.int64)
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).clone()
    out = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = torch.take_along_dim(ids[t], beam, dim=1)
        beam = torch.take_along_dim(par[t], beam, dim=1)
    return torch.stack(out)


# ---- losses ----

def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    lv = TF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype) if label.shape != input.shape else label.to(input.dtype)
    iv = input.reshape(input.shape[0], -1)
    lv = lv.reshape(lv.shape[0], -1)
    inter = (iv * lv).sum(dim=1)
    union = iv.sum(dim=1) + lv.sum(dim=1)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def bpr_loss(input, label, name=None):  # noqa: A002
    """Bayesian personalized ranking: -mean over the other classes of
    log σ(score_label - score_j), [N, 1]."""
    lv = label.reshape(-1).long()
    pos = torch.gather(input, 1, lv[:, None])
    log_sig = TF.logsigmoid(pos - input)
    c = input.shape[1]
    mask = TF.one_hot(lv, c).to(input.dtype)
    return -(log_sig * (1 - mask)).sum(dim=1, keepdim=True) / (c - 1)


def center_loss(input, label, num_classes, alpha, param_attr=None,  # noqa: A002
                update_center=True, name=None):
    """0.5 · |x - center[label]|², [N, 1]; the centers are a persistent
    buffer of the store (zeros at first), moved toward their rows by
    alpha / (count + 1) after each call when update_center."""
    lv = label.reshape(-1).long()
    d = input.shape[-1]
    bname = _attr_name(name, param_attr) or f"center_loss_{num_classes}_{d}"
    centers = _store.buffer(bname, lambda: torch.zeros(
        num_classes, d, dtype=input.dtype, device=input.device))
    centers = centers.to(input.device)
    diff = input - centers[lv]
    loss = 0.5 * (diff * diff).sum(dim=1, keepdim=True)
    if update_center:
        with torch.no_grad():
            counts = torch.zeros(num_classes, dtype=input.dtype,
                                 device=input.device).index_add_(
                0, lv, torch.ones_like(lv, dtype=input.dtype))
            upd = torch.zeros_like(centers).index_add_(0, lv, diff.detach())
            _store.set_buffer(bname, centers + alpha * upd
                              / (counts[:, None] + 1.0))
    return loss


def teacher_student_sigmoid_loss(input, label,  # noqa: A002
                                 soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """Distillation loss: the logistic loss on the click (z > 0) plus,
    where 0 < z < 1, the logistic loss against the teacher's z."""
    x = input.reshape(-1).clamp(soft_max_lower_bound, soft_max_up_bound)
    z = label.reshape(-1).to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    stu = torch.log1p(torch.exp(x)) - torch.where(z > 0, x, zero)
    has_teacher = (z > 0) & (z < 1)
    tea = torch.where(has_teacher, torch.log1p(torch.exp(x)) - x * z, zero)
    return (stu + tea)[:, None]


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False,
        generator=None):
    """Noise-contrastive estimation, [N, 1]: the label's logit against
    `num_neg_samples` uniform negatives a row (drawn on the input's
    device from `generator`, else the port's generator there), each
    shifted by log(k / num_total_classes)."""
    from ...core import rng
    from .. import initializer as I
    n, d = input.shape
    dev = input.device
    pname = _attr_name(name, param_attr)
    if pname:
        w = _store.parameter(f"nce/{pname}.w", (num_total_classes, d),
                             device=dev)
        b = _store.parameter(f"nce/{pname}.b", (num_total_classes,),
                             initializer=I.Constant(0.0), device=dev)
    else:
        w = I.XavierUniform()((num_total_classes, d), "float32", device=dev)
        b = torch.zeros(num_total_classes, dtype=torch.float32, device=dev)
    g = generator if generator is not None else rng.generator(dev)
    neg = torch.randint(0, num_total_classes, (n, num_neg_samples),
                        generator=g, device=g.device).to(dev)
    lv = label.reshape(-1).long()
    pos_logit = (input * w[lv]).sum(dim=1) + b[lv]
    neg_logit = torch.einsum("nd,nkd->nk", input, w[neg]) + b[neg]
    ln_k_pn = math.log(num_neg_samples * (1.0 / num_total_classes))
    pos_loss = -TF.logsigmoid(pos_logit - ln_k_pn)
    neg_loss = -TF.logsigmoid(-(neg_logit - ln_k_pn)).sum(dim=1)
    return (pos_loss + neg_loss)[:, None]


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over a complete binary tree: [N, 1] losses.
    Default tree: a label's path is its leaf's heap ancestors over
    ceil(log2(C)) internal nodes, the code its left / right bits."""
    lv = label.reshape(-1).to(torch.int64)
    n_nodes = weight.shape[0]
    if path_table is not None:
        table = path_table.to(torch.int64)
        code = path_code.to(input.dtype)
    else:
        depth = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
        node = lv + num_classes - 1  # the leaf's heap position
        tables, codes = [], []
        for _ in range(depth):
            codes.append((node % 2).to(input.dtype))  # left / right bit
            node = torch.div(node - 1, 2, rounding_mode="floor")
            tables.append(node)
        table = torch.stack(tables[::-1], dim=1)  # [N, depth]
        code = torch.stack(codes[::-1], dim=1)
    valid = (table >= 0) & (table < n_nodes)
    tsafe = table.clamp(0, n_nodes - 1)
    logits = torch.einsum("nd,nkd->nk", input, weight[tsafe])
    if bias is not None:
        logits = logits + bias.reshape(-1)[tsafe]
    lo = torch.where(code > 0.5, TF.logsigmoid(logits),
                     TF.logsigmoid(-logits))
    return -torch.where(valid, lo, torch.zeros_like(lo)).sum(dim=1,
                                                              keepdim=True)


def _crf_transitions(n, device):
    """The store's [n + 2, n] transition buffer (row 0 start, row 1 stop,
    rows 2: the transitions), zeros at first."""
    trans = _store.buffer(f"crf_transition_{n}", lambda: torch.zeros(
        n + 2, n, dtype=torch.float32, device=device))
    return trans.to(device)


def linear_chain_crf(input, label, param_attr=None, length=None):  # noqa: A002
    """Linear-chain CRF negative log-likelihood, [B, 1]: the float32
    log-sum-exp forward recursion for log Z minus the gold path's score.
    input [B, T, n_tags]; the transitions are the store's buffer."""
    lv = label.long()
    if lv.dim() == 3:
        lv = lv.squeeze(-1)
    b, t, n = input.shape
    dev = input.device
    trans = _crf_transitions(n, dev)
    start, stop, tr = trans[0], trans[1], trans[2:]
    lens = (length.reshape(-1).to(dev).long() if length is not None
            else torch.full((b,), t, dtype=torch.int64, device=dev))
    emis = input.float()
    alpha = start[None] + emis[:, 0]
    for i in range(1, t):
        scores = alpha[:, :, None] + tr[None] + emis[:, i][:, None, :]
        new = torch.logsumexp(scores, dim=1)
        alpha = torch.where((i < lens)[:, None], new, alpha)
    log_z = torch.logsumexp(alpha + stop[None], dim=1)
    pos = torch.arange(t, device=dev)[None]
    msk = (pos < lens[:, None]).float()
    unary = torch.gather(emis, 2, lv[:, :, None])[:, :, 0]
    gold_unary = (unary * msk).sum(dim=1)
    pair = tr[lv[:, :-1], lv[:, 1:]]
    pair_msk = (pos[:, 1:] < lens[:, None]).float()
    gold_pair = (pair * pair_msk).sum(dim=1)
    last = torch.gather(lv, 1, (lens - 1).clamp_min(0)[:, None])[:, 0]
    gold = start[lv[:, 0]] + gold_unary + gold_pair + stop[last]
    return (log_z - gold)[:, None]


def crf_decoding(input, param_attr=None, label=None, length=None):  # noqa: A002
    """Viterbi decode with the store's transitions: [B, T] tags; ties go
    to the first index, as the reference's argmax."""
    emis = input.float()
    b, t, n = emis.shape
    trans = _crf_transitions(n, emis.device)
    start, stop, tr = trans[0], trans[1], trans[2:]
    score = start[None] + emis[:, 0]
    backs = []
    for i in range(1, t):
        cand = score[:, :, None] + tr[None]
        backs.append(cand.argmax(dim=1))
        score = cand.amax(dim=1) + emis[:, i]
    cur = (score + stop[None]).argmax(dim=1)
    path = [cur]
    for back in reversed(backs):
        cur = torch.gather(back, 1, cur[:, None])[:, 0]
        path.append(cur)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def warpctc(input, label, blank=0, norm_by_times=False,  # noqa: A002
            input_length=None, label_length=None):
    return ops.ctc_loss(input, label, input_length, label_length,
                        blank=blank, reduction="none")


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1ᵀ W_o x2 (+ b_o) for every output o: [B, I], [B, J], [O, I, J]
    -> [B, O]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from .. import initializer as I
    shape = (size, x.shape[-1], y.shape[-1])
    pname = _attr_name(name, param_attr)
    w = _store.parameter(f"bilinear_tensor_product/{pname}", shape,
                         device=x.device) if pname \
        else I.XavierUniform()(shape, "float32", device=x.device)
    return _act(bilinear(x, y, w), act)


def deformable_conv(input, offset, mask, num_filters, filter_size,  # noqa: A002
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    """Deformable convolution v2 (the reference's: the first deformable
    group's offsets for every channel): each kernel tap samples the input
    bilinearly at its offset position (zeros outside), optionally scaled
    by the mask, then one product with the weight [F, C, kh, kw]."""
    from .. import initializer as I
    n, c, h, w = input.shape
    kh, kw = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    st = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    pd = padding if isinstance(padding, (list, tuple)) \
        else (padding, padding)
    ho = (h + 2 * pd[0] - kh) // st[0] + 1
    wo = (w + 2 * pd[1] - kw) // st[1] + 1
    dev = input.device
    pname = _attr_name(name, param_attr)
    wshape = (num_filters, c, kh, kw)
    wgt = _store.parameter(f"deformable_conv/{pname}", wshape,
                           initializer=I.KaimingUniform(), device=dev) \
        if pname else I.KaimingUniform()(wshape, "float32", device=dev)
    ys = torch.arange(ho, device=dev) * st[0] - pd[0]
    xs = torch.arange(wo, device=dev) * st[1] - pd[1]
    base_y = ys[:, None, None, None] + torch.arange(kh, device=dev)[
        None, None, :, None]
    base_x = xs[None, :, None, None] + torch.arange(kw, device=dev)[
        None, None, None, :]
    off_r = offset.reshape(n, deformable_groups, kh, kw, 2, ho, wo)
    dy = off_r[:, 0, :, :, 0].permute(0, 3, 4, 1, 2)  # [N, Ho, Wo, kh, kw]
    dx = off_r[:, 0, :, :, 1].permute(0, 3, 4, 1, 2)
    py = base_y[None].float() + dy
    px = base_x[None].float() + dx
    y0 = torch.floor(py).long()
    x0 = torch.floor(px).long()
    wy = py - y0
    wx = px - x0
    img = input.permute(0, 2, 3, 1)  # [N, H, W, C]
    nidx = torch.arange(n, device=dev)[:, None, None, None, None]

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        g = img[nidx, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(valid[..., None], g, 0.0)

    val = (sample(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + sample(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + sample(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + sample(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    if modulated and mask is not None:
        mv = mask.reshape(n, deformable_groups, kh, kw, ho, wo)[:, 0]
        val = val * mv.permute(0, 3, 4, 1, 2)[..., None]
    return torch.einsum("nhwklc,ockl->nohw", val, wgt)


__all__ = [
    "LegacyParamStore", "legacy_param_store", "fc", "erf", "soft_relu",
    "assign", "smooth_l1", "pad2d", "pad_constant_like", "affine_channel",
    "data_norm", "add_position_encoding", "space_to_depth",
    "shuffle_channel", "similarity_focus", "fsp_matrix", "hash",
    "im2sequence", "autoincreased_step_counter", "continuous_value_model",
    "filter_by_instag", "polygon_box_transform", "create_array",
    "array_write", "array_read", "array_length", "tensor_array_to_tensor",
    "lod_reset", "lod_append", "merge_selected_rows",
    "reorder_lod_tensor_by_rank", "image_resize", "resize_bilinear",
    "resize_nearest", "resize_trilinear", "image_resize_short",
    "random_crop", "pool2d", "pool3d", "birnn", "lstm", "dynamic_lstm",
    "dynamic_lstmp", "dynamic_gru", "gru_unit", "lstm_unit", "row_conv",
    "gather_tree", "dice_loss", "bpr_loss", "center_loss",
    "teacher_student_sigmoid_loss", "nce", "hsigmoid_loss",
    "linear_chain_crf", "crf_decoding", "warpctc", "bilinear",
    "bilinear_tensor_product", "deformable_conv"]
