"""GPT-2 parameters in the reference's flat layout.

The serving path reads a GPT-2-layout decoder as a FLAT dict of named
tensors — the names `paddle_tpu`'s `GPT2.functional_state()` produces
("wte.weight", "h.{i}.qkv_proj.weight", ...), with every projection
stored `[in, out]` and applied as `x @ W` (the decode programs of
`nn/decode.py`). `GPT2` here is an `nn.Module` whose `named_parameters()`
are exactly those names and layouts, so `flat_params()` is the dict the
decoder consumes and `from_reference_params` is a name-for-name copy of
the reference's numpy weights (the bridge the parity tests use).

`forward` (the training path) belongs to the training slice of the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 1024
    intermediate_size: int = None  # defaults to 4*hidden
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def medium(cls):
        return cls(hidden_size=1024, num_layers=24, num_heads=16)

    @classmethod
    def large(cls):
        return cls(hidden_size=1280, num_layers=36, num_heads=20)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_layers=2,
                   num_heads=4, max_position=256)


def param_shapes(cfg):
    """{flat name: shape} of a GPT-2-layout decoder — the reference's
    `functional_state()` keys, projections `[in, out]`."""
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"wte.weight": (V, E), "wpe.weight": (cfg.max_position, E)}
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        shapes.update({
            p + "ln_1.weight": (E,), p + "ln_1.bias": (E,),
            p + "qkv_proj.weight": (E, 3 * E), p + "qkv_proj.bias": (3 * E,),
            p + "out_proj.weight": (E, E), p + "out_proj.bias": (E,),
            p + "ln_2.weight": (E,), p + "ln_2.bias": (E,),
            p + "fc1.weight": (E, F), p + "fc1.bias": (F,),
            p + "fc2.weight": (F, E), p + "fc2.bias": (E,),
        })
    shapes.update({"ln_f.weight": (E,), "ln_f.bias": (E,)})
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (E, V)
    return shapes


class _Leaf(nn.Module):
    """A module holding named parameters and nothing else (so the
    parameter paths spell the reference's flat names)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(
                name, nn.Parameter(t, requires_grad=False))


class _Block(nn.Module):
    def __init__(self, leaves):
        super().__init__()
        for name, leaf in leaves.items():
            setattr(self, name, leaf)


class GPT2(nn.Module):
    """GPT-2-layout decoder parameters, initialized from a seeded
    `torch.Generator`: embeddings normal(0, 0.02) (as the reference),
    projections Xavier-uniform (the reference Linear's default init
    scale), biases zero, layer norms (1, 0).

    device: None -> CUDA (raises when absent); pass "cpu" for the plain
    path. dtype: parameter dtype (float32 default; bfloat16 for
    serving). init=False leaves the parameters unset, for callers that
    load weights into them (`from_reference_params`)."""

    def __init__(self, cfg: GPT2Config = None, *, seed=0,
                 dtype=torch.float32, device=None, init=True):
        super().__init__()
        self.cfg = cfg or GPT2Config()
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        shapes = param_shapes(self.cfg)

        def make(name):
            shape = shapes[name]
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            if not init:
                return t.to(dtype)
            leaf = name.rsplit(".", 1)
            if name in ("wte.weight", "wpe.weight"):
                t.normal_(0.0, 0.02, generator=g)
            elif leaf[0].endswith(("ln_1", "ln_2", "ln_f")):
                t.fill_(1.0 if leaf[1] == "weight" else 0.0)
            elif leaf[1] == "bias":
                t.zero_()
            else:  # projection [in, out]
                bound = math.sqrt(6.0 / (shape[0] + shape[1]))
                t.uniform_(-bound, bound, generator=g)
            return t.to(dtype)

        def leaf(prefix, *names):
            return _Leaf(**{n: make(f"{prefix}.{n}") for n in names})

        self.wte = leaf("wte", "weight")
        self.wpe = leaf("wpe", "weight")
        blocks = []
        for i in range(self.cfg.num_layers):
            p = f"h.{i}"
            blocks.append(_Block({
                "ln_1": leaf(p + ".ln_1", "weight", "bias"),
                "qkv_proj": leaf(p + ".qkv_proj", "weight", "bias"),
                "out_proj": leaf(p + ".out_proj", "weight", "bias"),
                "ln_2": leaf(p + ".ln_2", "weight", "bias"),
                "fc1": leaf(p + ".fc1", "weight", "bias"),
                "fc2": leaf(p + ".fc2", "weight", "bias"),
            }))
        self.h = nn.ModuleList(blocks)
        self.ln_f = leaf("ln_f", "weight", "bias")
        if not self.cfg.tie_embeddings:
            self.lm_head = leaf("lm_head", "weight")

    def flat_params(self):
        """{flat name: tensor} — the dict the decode programs read
        (same names and layouts as the reference's functional_state)."""
        return {n: p.detach() for n, p in self.named_parameters()}

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "GPT2.forward (the training path) comes with the training "
            "slice of the port; serving reads flat_params() through "
            "nn.decode.PagedDecoder")


def from_reference_params(cfg, params_np, *, device=None):
    """The weight bridge: a `GPT2` holding exactly the reference's flat
    params (`functional_state()` converted to numpy), name for name and
    in the same `[in, out]` layout.

    Rejects the W8A16 `::w8c`/`::w8s` keys (int8 weight serving is a
    later slice) and any missing, unexpected or misshaped entry. Each
    tensor keeps its array's float dtype."""
    quant = sorted(k for k in params_np if "::w8" in k)
    if quant:
        raise ValueError(
            f"W8A16 weights ({quant[0]!r}, ...) are not served by this "
            f"slice of the port: int8 weight serving comes with the "
            f"W8A16/int8-KV serving slice; pass unquantized params")
    shapes = param_shapes(cfg)
    missing = sorted(set(shapes) - set(params_np))
    extra = sorted(set(params_np) - set(shapes))
    if missing or extra:
        raise ValueError(f"reference params do not match GPT2Config: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    model = GPT2(cfg, device=device, init=False)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = np.asarray(params_np[name])
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)  # bf16 numpy (ml_dtypes) et al.
            if tuple(a.shape) != tuple(shapes[name]):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{shapes[name]}")
            t = torch.from_numpy(np.array(a))  # a writable copy
            p.data = t.to(p.device)
    return model


__all__ = ["GPT2Config", "GPT2", "from_reference_params", "param_shapes"]
