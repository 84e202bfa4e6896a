"""`paddle.nn.utils` of the port: `weight_norm` / `remove_weight_norm`
(the port of `paddle_tpu/nn/utils/__init__.py`: w = g · v / ‖v‖ over
every dim but `dim`, recomputed from the parameters `{name}_g` and
`{name}_v` by a forward pre-hook, so the optimizer trains g and v; the
fold back gives one parameter again, appended last),
`parameters_to_vector` / `vector_to_parameters`, and `clip_grad_norm_` /
`clip_grad_value_` (`nn.clip`)."""
from __future__ import annotations

import torch

from ...core.tensor import make_parameter
from ..clip import clip_grad_norm_, clip_grad_value_  # noqa: F401


def parameters_to_vector(parameters):
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters):
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n


def _norm_except_dim(v, dim):
    if dim is None or dim == -1:
        return torch.sqrt(torch.sum(v * v))
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


class _WeightNormHook:
    """w = g · v / ‖v‖, recomputed before every forward."""

    def __init__(self, name, dim):
        self.name, self.dim = name, dim

    def compute(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        return v * (g / _norm_except_dim(v, self.dim))

    def __call__(self, layer, inputs):
        object.__setattr__(layer, self.name, self.compute(layer))
        return None


def weight_norm(layer, name="weight", dim=0):
    hooks = layer.__dict__.setdefault("_weight_norm_hooks", {})
    if name in hooks:
        raise ValueError(f"weight_norm already applied to '{name}'")
    w = getattr(layer, name)
    if dim is not None and not (-1 <= dim <= w.dim() - 1):
        raise ValueError(f"dim must be in [-1, {w.dim() - 1}] for a "
                         f"{w.dim()}-D weight, got {dim}")
    hook = _WeightNormHook(name, dim)
    with torch.no_grad():
        g0 = _norm_except_dim(w.detach(), dim)
    del layer._parameters[name]
    layer.register_parameter(name + "_g", make_parameter(g0.clone()))
    layer.register_parameter(name + "_v", make_parameter(w.detach().clone()))
    hooks[name] = (hook, layer.register_forward_pre_hook(hook))
    object.__setattr__(layer, name, hook.compute(layer))
    return layer


def remove_weight_norm(layer, name="weight"):
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm was not applied to '{name}'")
    hook, handle = hooks.pop(name)
    with torch.no_grad():
        w = make_parameter(hook.compute(layer).detach().clone())
    handle.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, w)
    return layer


__all__ = ["weight_norm", "remove_weight_norm", "parameters_to_vector",
           "vector_to_parameters", "clip_grad_norm_", "clip_grad_value_"]
