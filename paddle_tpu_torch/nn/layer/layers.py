"""`Layer`: the port of `paddle_tpu/nn/layer/layers.py:32-330`, a
`torch.nn.Module` with Paddle's surface, and the containers
`Sequential`, `LayerList`, `ParameterList`.

  * `create_parameter(shape, attr=None, dtype=None, is_bias=False,
    default_initializer=None)` reads a `ParamAttr` (its initializer, or
    the global one, or the default: Constant(0) for a bias, XavierUniform
    for a weight; name, learning-rate scale, regularizer, trainable,
    need_clip) and returns a `torch.nn.Parameter` carrying those fields,
    on the default device (`device.resolve_device`) drawing from the
    port's generator there — or, given the port's keyword `generator=`,
    on that generator's device drawing from it (the models build this
    way, on the CPU, then move);
  * `add_parameter`, `add_sublayer`, `register_buffer(name, tensor,
    persistable=True)`, `named_sublayers(prefix, include_self)` /
    `sublayers`, `parameters()` (a list), `buffers()`;
  * `register_forward_pre_hook(hook(layer, inputs))` and
    `register_forward_post_hook(hook(layer, inputs, outputs))`, torch's
    hooks, each returning a handle with `remove()`;
  * `state_dict()` — the parameters then the buffers (every buffer, as
    the reference), under structured names — and `set_state_dict(state,
    use_structured_name=True)` copying values (tensors or arrays, any
    device) in place, by structured name or (False) by parameter name
    (`param_name`),
    returning (missing, unexpected);
  * `full_name()` from `core.unique_name`; `to(device=None, dtype=None)`
    accepting Paddle's dtype names and places.
`named_parameters()` and `state_dict()` spell the reference's keys for
every layer class of the port.

`load_reference_state(layer, state)` loads the reference layer's
`state_dict()` given as {structured name: numpy array}. Every layer
class of the port keeps the reference's layout, so no value is
converted: Linear's weight is [in, out] on both sides; conv weights are
[out, in / groups, *k] (transposed convs [in, out / groups, *k]) for
every `data_format` — NHWC moves the input's channels, not the weight's;
the RNN weights are [gates · hidden, in] with the reference's gate
order (LSTM i, f, g, o; GRU r, z, c) and names (`weight_ih_l0`,
`bias_hh_l0_reverse`, ...); BatchNorm's running statistics are the
buffers `_mean` / `_variance`. bfloat16 arrays are read through
float32; a 0-d buffer (slim's `act_scale`) takes the reference's
one-element array. A key the port's layer lacks, or a shape that
differs, raises.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ...core import dtype as dtype_mod
from ...core import unique_name
from ...core.param_attr import ParamAttr
from ...core.tensor import make_parameter
from ...device import _parse
from .. import initializer as I


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()
        self._full_name = unique_name.generate(self._name_scope)

    # ---- construction ----------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, generator=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer
                or I._global_initializer["bias" if is_bias else "weight"]
                or default_initializer)
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        value = init(shape, dtype or self._dtype, generator=generator)
        return make_parameter(
            value, name=attr.name or unique_name.generate("param"),
            trainable=attr.trainable, regularizer=attr.regularizer,
            learning_rate=attr.learning_rate, need_clip=attr.need_clip)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    # ---- traversal -------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return list(super().parameters(recurse=include_sublayers))

    def named_parameters(self, prefix="", include_sublayers=True,
                     remove_duplicate=True, recurse=None):
        if recurse is not None:  # torch's keyword
            include_sublayers = recurse
        return super().named_parameters(prefix, include_sublayers,
                                    remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return list(super().buffers(recurse=include_sublayers))

    def named_buffers(self, prefix="", include_sublayers=True,
                     remove_duplicate=True, recurse=None):
        if recurse is not None:  # torch's keyword
            include_sublayers = recurse
        return super().named_buffers(prefix, include_sublayers,
                                    remove_duplicate)

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # ---- hooks -----------------------------------------------------------
    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    # ---- state -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kw):
        if torch_kw:  # torch's own recursion (prefix=, keep_vars=)
            return super().state_dict(destination=destination, **torch_kw)
        dest = destination if destination is not None \
            else collections.OrderedDict()
        pre = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(pre, include_sublayers):
            dest[name] = p.detach()
        for name, b in self.named_buffers(pre, include_sublayers):
            dest[name] = b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = dict(self.named_parameters())
        own.update(self.named_buffers())
        if not use_structured_name:
            own = {getattr(t, "param_name", None) or n: t
                   for n, t in own.items()}
        missing = [n for n in own if n not in state_dict]
        unexpected = [n for n in state_dict if n not in own]
        with torch.no_grad():
            for name, t in own.items():
                if name in state_dict:
                    t.copy_(_as_tensor(state_dict[name]).reshape(t.shape))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def to(self, *args, **kwargs):
        """torch's `to`, also taking Paddle's dtype names and places:
        `to(device=None, dtype=None)`, `to("gpu:0")`, `to("bfloat16")`."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if torch.is_tensor(a):  # torch's to(other): its device, dtype
                device, dtype = a.device, a.dtype
            elif isinstance(a, torch.dtype) or _is_dtype_name(a):
                dtype = a
            else:
                device = a
        if dtype is not None:
            dtype = dtype_mod.convert_dtype(dtype)
        if device is not None:
            device = _parse(device)
        return super().to(device=device, dtype=dtype, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self):
        return self._full_name


def _is_dtype_name(a):
    try:
        return isinstance(a, str) and bool(dtype_mod.dtype_name(a))
    except ValueError:
        return False


def _as_tensor(v):
    if torch.is_tensor(v):
        return v.detach()
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def load_reference_state(layer, state):
    """Load the reference layer's `state_dict()` ({structured name: numpy
    array}) into `layer` (see the module docstring: no layout differs).
    Raises KeyError for a name `layer` lacks and ValueError for a shape
    that differs; returns the names `state` did not cover."""
    own = dict(layer.named_parameters())
    own.update(layer.named_buffers())
    extra = [k for k in state if k not in own]
    if extra:
        raise KeyError(f"not in the port's layer: {extra}")
    with torch.no_grad():
        for name, v in state.items():
            t = own[name]
            src = _as_tensor(v)
            if t.dim() == 0 and src.numel() == 1:
                src = src.reshape(())  # the reference's numpy() of a 0-d
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(src.shape)}, port {tuple(t.shape)}")
            t.copy_(src)
    return [n for n in own if n not in state]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._modules.values())[idx]
        return self._modules[str(idx % len(self))]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx % len(self)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx % len(self))]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, p):
        self.add_parameter(str(len(self)), p)
        return self


__all__ = ["Layer", "Sequential", "LayerList", "ParameterList",
           "load_reference_state"]
