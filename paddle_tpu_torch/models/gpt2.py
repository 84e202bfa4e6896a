"""GPT-2 in the reference's flat parameter layout: the weights, and the
training path.

The serving path reads a GPT-2-layout decoder as a FLAT dict of named
tensors — the names `paddle_tpu`'s `GPT2.functional_state()` produces
("wte.weight", "h.{i}.qkv_proj.weight", ...), with every projection
stored `[in, out]` and applied as `x @ W` (the decode programs of
`nn/decode.py`). `GPT2` here is an `nn.Module` whose `named_parameters()`
are exactly those names and layouts, so `flat_params()` is the dict the
decoder consumes and `from_reference_params` is a name-for-name copy of
the reference's numpy weights (the bridge the parity tests use).
`GPT2.quantize_weights` packs that dict for W8A16 serving as the
reference does (int8 codes `name::w8c`, scales `name::w8s`), and
`quantized_params_from_reference` carries the reference's packed dict
across.

The training path is a set of pure functions of that dict, as the
reference's `build_train_step` re-binds its params per call:
`hidden_states` (pre-LN blocks, fused QKV split as [3, B, H, S, D],
causal attention through `ops.scaled_dot_product_attention` — the flash
kernels K4/K6 with K9, or K7/K8 past the reference's length switch, on
the card; with an additive [B or 1, 1, 1, S] `attn_mask` (a padded
batch) their per-key-bias variants; with attention dropout the dense
path, as the reference — tanh GELU, final layer norm), `logits`
(the tied head as one rank-2 product `x2 @ wte.T`) and `lm_loss` (mean
cross-entropy; the reference's vocab-chunked loss under
`PADDLE_TPU_CHUNKED_CE=<n>`, `ops/chunked_xent.py`).
`build_train_step(cfg)` returns `loss_fn(params, batch)` and
`init_params()`; `GPT2.forward`/`GPT2.loss` run the same functions on
the module's own parameters. `position_ids` ([S] or [B, S]; default
0..S-1) and `attn_mask` are the reference's `GPT2.forward` arguments;
`lm_loss`, `GPT2.loss` and `build_train_step` take no mask, as the
reference's do (a padded batch composes `logits(..., attn_mask=)` with
`ops.loss.cross_entropy`, pad labels -100). Embedding, residual and
attention dropout draw from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import scaled_dot_product_attention
from ..ops.chunked_xent import chunked_softmax_xent
from ..ops.loss import cross_entropy


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
            self.register_parameter(name, nn.Parameter(t))


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
        (same names and layouts as the reference's functional_state),
        detached from autograd."""
        return {n: p.detach() for n, p in self.named_parameters()}

    def quantize_weights(self, params=None):
        """Weight-only int8 (W8A16) packing of the decode path's large 2-D
        weights, the reference's `GPT2.quantize_weights`: a NEW flat dict
        where each quantized weight `name` is replaced by `name::w8c`
        (int8 codes) and `name::w8s` (scales in the weight's dtype); every
        other entry passes through. `params` defaults to `flat_params()`.
        The serving engine calls it once, at construction."""
        if params is None:
            params = self.flat_params()
        return quantize_decode_weights_int8(params, self.cfg)

    def _dropout(self):
        return self.cfg.dropout if self.training else 0.0

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                generator=None):
        """Logits [B, S, V] in the parameters' dtype (arguments as the
        reference's `GPT2.forward`; `generator` draws the dropout)."""
        return logits(dict(self.named_parameters()), self.cfg, input_ids,
                      position_ids=position_ids, attn_mask=attn_mask,
                      dropout=self._dropout(), generator=generator)

    def loss(self, input_ids, labels, generator=None):
        return lm_loss(dict(self.named_parameters()), self.cfg, input_ids,
                       labels, dropout=self._dropout(), generator=generator)


# ---- the training path: pure functions of the flat param dict ------------

def _dropout(x, p, generator):
    """Inverted dropout drawing its mask from `generator` (identity at
    p == 0)."""
    if p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def _linear(x, w, b):
    """x @ w + b for a [in, out] weight, as one GEMM with the bias."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def _block(p, i, x, cfg, dropout, generator, attn_mask=None):
    """One pre-LN decoder block (the reference's `GPT2Block.forward`); the
    mask goes to the attention unchanged."""
    B, S, E = x.shape
    H = cfg.num_heads
    pre = f"h.{i}."
    eps = cfg.layer_norm_epsilon
    a = F.layer_norm(x, (E,), p[pre + "ln_1.weight"], p[pre + "ln_1.bias"],
                     eps)
    qkv = _linear(a, p[pre + "qkv_proj.weight"], p[pre + "qkv_proj.bias"])
    qkv = qkv.reshape(B, S, 3, H, E // H).permute(2, 0, 3, 1, 4)
    o, _ = scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                        attn_mask=attn_mask, is_causal=True,
                                        dropout_p=dropout,
                                        generator=generator)
    o = o.permute(0, 2, 1, 3).reshape(B, S, E)
    x = x + _dropout(_linear(o, p[pre + "out_proj.weight"],
                             p[pre + "out_proj.bias"]), dropout, generator)
    m = F.layer_norm(x, (E,), p[pre + "ln_2.weight"], p[pre + "ln_2.bias"],
                     eps)
    m = F.gelu(_linear(m, p[pre + "fc1.weight"], p[pre + "fc1.bias"]),
               approximate="tanh")
    m = _linear(m, p[pre + "fc2.weight"], p[pre + "fc2.bias"])
    return x + _dropout(m, dropout, generator)


def hidden_states(params, cfg, input_ids, *, position_ids=None,
                  attn_mask=None, dropout=0.0, generator=None):
    """The transformer body up to and including the final layer norm:
    [B, S, E] for input_ids [B, S]; position_ids [S] or [B, S] (default
    0..S-1), attn_mask an additive mask for every layer's attention."""
    if position_ids is None:
        position_ids = torch.arange(input_ids.shape[1],
                                    device=input_ids.device)
    x = F.embedding(input_ids, params["wte.weight"]) \
        + F.embedding(position_ids, params["wpe.weight"])
    x = _dropout(x, dropout, generator)
    for i in range(cfg.num_layers):
        x = _block(params, i, x, cfg, dropout, generator, attn_mask)
    return F.layer_norm(x, (cfg.hidden_size,), params["ln_f.weight"],
                        params["ln_f.bias"], cfg.layer_norm_epsilon)


def logits(params, cfg, input_ids, *, position_ids=None, attn_mask=None,
           dropout=0.0, generator=None):
    """[B, S, V] logits. The head is one rank-2 product over [B*S, E]
    (the reference's layout choice, `models/gpt2.py:122-133`)."""
    B, S = input_ids.shape
    x2 = hidden_states(params, cfg, input_ids, position_ids=position_ids,
                       attn_mask=attn_mask, dropout=dropout,
                       generator=generator).reshape(-1, cfg.hidden_size)
    if cfg.tie_embeddings:
        lg = x2 @ params["wte.weight"].T
    else:
        lg = x2 @ params["lm_head.weight"]
    return lg.reshape(B, S, cfg.vocab_size)


def lm_loss(params, cfg, input_ids, labels, *, dropout=0.0,
            generator=None):
    """Mean next-token cross-entropy (labels of -100 are ignored). With
    `PADDLE_TPU_CHUNKED_CE=<n>` (n > 1) and tied embeddings, the
    reference's switch read at each call (`GPT2.loss`,
    `paddle_tpu/models/gpt2.py:135-150`), the vocab-chunked loss of the
    final hidden states against wte, which never holds the [B*S, V]
    logits."""
    n_chunks = int(os.environ.get("PADDLE_TPU_CHUNKED_CE", "0"))
    if n_chunks > 1 and cfg.tie_embeddings:
        h = hidden_states(params, cfg, input_ids, dropout=dropout,
                          generator=generator)
        return chunked_softmax_xent(h.reshape(-1, cfg.hidden_size),
                                    params["wte.weight"], labels.reshape(-1),
                                    n_chunks)
    lg = logits(params, cfg, input_ids, dropout=dropout, generator=generator)
    return cross_entropy(lg.reshape(-1, cfg.vocab_size), labels.reshape(-1))


def build_train_step(cfg, dtype=torch.float32, device=None):
    """The functional GPT-2 loss, as the reference's `build_train_step`:
    returns (loss_fn(params, batch, generator=None), init_params()).

    `init_params()` gives a fresh {flat name: leaf tensor requiring
    grad} of a `GPT2(cfg, dtype=dtype, device=device)` (seed 0; CUDA
    unless device="cpu"). `loss_fn` runs the training forward (dropout
    `cfg.dropout` from `generator`) on any such dict and batch
    {"input_ids": [B, S], "labels": [B, S]} and returns the scalar loss
    in the params' dtype; mixed precision is the caller's: pass bf16
    copies of float32 masters and cast the loss to float32."""
    model = GPT2(cfg, dtype=dtype, device=device)

    def init_params():
        return {n: p.detach().clone().requires_grad_(True)
                for n, p in model.named_parameters()}

    def loss_fn(params, batch, generator=None):
        return lm_loss(params, cfg, batch["input_ids"], batch["labels"],
                       dropout=cfg.dropout, generator=generator)

    return loss_fn, init_params


def _w8_weights(cfg):
    """(name, reduction axis) of each weight W8A16 quantizes: wte per
    ROW (its scale serves the embedding gather and the tied head);
    lm_head (untied) and each layer's qkv_proj, out_proj, fc1 and fc2
    per output COLUMN."""
    return ([("wte.weight", 1)]
            + ([] if cfg.tie_embeddings else [("lm_head.weight", 0)])
            + [(f"h.{i}.{part}.weight", 0) for i in range(cfg.num_layers)
               for part in ("qkv_proj", "out_proj", "fc1", "fc2")])


def quantize_decode_weights_int8(params, cfg):
    """Per-channel symmetric int8 of the reference's
    `_quantize_decode_weights_int8`: codes = clip(round(w / s), +-127)
    with s = max(amax, 1e-12) / 127, all in float32 (`torch.round` rounds
    half to even, as `jnp.round`), so the codes equal the reference's bit
    for bit; the weights and axes of `_w8_weights`."""
    out = dict(params)
    for name, axis in _w8_weights(cfg):
        w = out.pop(name)
        wf = w.float()
        amax = wf.abs().amax(dim=axis, keepdim=True)
        scale = amax.clamp_min(1e-12) / 127.0
        out[name + "::w8c"] = torch.round(wf / scale).clamp(
            -127, 127).to(torch.int8)
        out[name + "::w8s"] = scale.squeeze(axis).to(w.dtype)
    return out


def quantized_param_shapes(cfg):
    """{flat name: shape} of W8A16 params: `param_shapes` with each
    quantized weight replaced by its codes (the weight's shape) and its
    scales (one per row of wte, one per output column otherwise)."""
    shapes = param_shapes(cfg)
    for name, axis in _w8_weights(cfg):
        shape = shapes.pop(name)
        shapes[name + "::w8c"] = shape
        shapes[name + "::w8s"] = (shape[1 - axis],)
    return shapes


def _host_tensor(a):
    """numpy -> a CPU tensor of the same dtype (a bf16 array of
    ml_dtypes through float32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def quantized_params_from_reference(cfg, params_np, *, device=None):
    """The W8A16 weight bridge: the reference's quantized flat params
    (`GPT2.quantize_weights()` or the `export_generator` artifact's
    keys, as numpy) as the port's flat dict on `device` (None -> CUDA),
    name for name: int8 codes, scales and every other entry in their
    own float dtype. Raises on a missing, unexpected, misshaped or
    mistyped entry."""
    shapes = quantized_param_shapes(cfg)
    missing = sorted(set(shapes) - set(params_np))
    extra = sorted(set(params_np) - set(shapes))
    if missing or extra:
        raise ValueError(f"W8A16 reference params do not match GPT2Config: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    dev = resolve_device(device)
    out = {}
    for name, shape in shapes.items():
        t = _host_tensor(params_np[name])
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        codes = name.endswith("::w8c")
        if codes != (t.dtype == torch.int8) or not (
                codes or t.is_floating_point()):
            raise ValueError(f"{name}: dtype {t.dtype}, expected "
                             f"{'int8' if codes else 'a float dtype'}")
        out[name] = t.to(dev)
    return out


def from_reference_params(cfg, params_np, *, device=None):
    """The weight bridge: a `GPT2` holding exactly the reference's flat
    params (`functional_state()` converted to numpy), name for name and
    in the same `[in, out]` layout.

    Rejects the W8A16 `::w8c`/`::w8s` keys (a module holds float
    parameters: `quantized_params_from_reference` carries those into a
    flat dict) and any missing, unexpected or misshaped entry. Each
    tensor keeps its array's float dtype."""
    quant = sorted(k for k in params_np if "::w8" in k)
    if quant:
        raise ValueError(
            f"W8A16 weights ({quant[0]!r}, ...) cannot load into a GPT2 "
            f"module, which holds float parameters: carry them with "
            f"quantized_params_from_reference(cfg, params_np, device=...) "
            f"into a flat dict for the decoder")
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


__all__ = ["GPT2Config", "GPT2", "from_reference_params", "param_shapes",
           "quantize_decode_weights_int8", "quantized_param_shapes",
           "quantized_params_from_reference",
           "build_train_step", "hidden_states", "logits", "lm_loss"]
