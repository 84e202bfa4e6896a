"""paddle.jit: `to_static`, `save` / `load` of any layer, and the
exported text generator; the port of `paddle_tpu/jit/__init__.py`.

to_static. The reference hands a layer's forward to `jax.jit`. The port
runs it eagerly: the kernels are what is compiled, and a CUDA graph
replays a fixed-shape program on the card (`inference.Predictor`); it
never calls `torch.compile`, whose generated kernels the port does not
own. `to_static` keeps the reference's state rules: a decorated
layer's buffers persist (BatchNorm's running statistics advance), its
forward hooks run, dropout draws afresh at every call, and a decorated
FREE function leaks no state — the buffers of every layer it reaches
(its globals and closure) are restored after the call, as a pure
`jax.jit` drops them. `not_to_static`, `ignore_module`,
`ProgramTranslator`, `enable_to_static` (off: the plain function),
`set_verbosity` / `set_code_level` and `TracedLayer` are the
reference's.

The artifact. `save(layer, path, input_spec)` exports `pure(params,
buffers, *inputs)` — `torch.func.functional_call` of the layer in eval
mode over its parameters and buffers — with `torch.export.export`, as
the reference exports its `pure` with `jax.export`:

  * `.pdmodel`: `MAGIC` (the port's own; neither loader takes the
    other's file for a program it can run), an 8-byte little-endian
    header length, the JSON meta, then the serialized `ExportedProgram`
    (`torch.export.save`). The meta of a layer has `format`
    (`LAYER_FORMAT`), `kind` ("layer"), `class_name`, `in_specs` (each
    input's shape with None for a free dim, and dtype) and the
    parameter and buffer names in the program's order. The port's
    attention is one `paddle_tpu_torch::flash_attn` node a layer: the
    op is registered when this package is imported, so a fresh process
    that imports `paddle_tpu_torch.jit` (or `.inference`) loads it with
    no model class;
  * `.pdiparams`: the reference's npz — parameters under `p:` keys,
    buffers under `b:` keys; dtypes numpy lacks (bfloat16) as a uint8
    view with the itemsize as a last axis and a `dt:` sidecar naming the
    dtype. The weights are stored once: the program takes them as
    inputs and holds no copy.

A None (or -1) dim of an `InputSpec` is `torch.export.Dim.AUTO`: the
export keeps it symbolic unless the model forces it (dims the model
makes equal, as the batch of ids and mask, share one symbol). The
example size of a free dim is 2 + its axis, never 0 or 1, which export
would specialise. A loaded program is batch-polymorphic on those dims.
Export bakes the device of factory calls (`arange`, ...) into the graph;
`load` rewrites them to the device it loads onto.

`load(path, device=None)` dispatches on the meta's `kind`: a layer or a
static program (`static.save_inference_model`, kind "program") gives a
`TranslatedLayer`, whose weights go to the device once, at load (CUDA
unless device="cpu"; raises when no card is present); an
`export_generator` artifact (kind "gpt2_generator", `FORMAT`, no program
body: the loader rebuilds the decode program from the port's own code,
`models/gpt2_decode.py`) gives a `TranslatedGenerator`, a callable
`(ids, seed, temperature, eos, top_p, pad) -> [B, prompt_len +
max_new_tokens]` int32 CPU tensor (`batch_size=None` artifacts take any
batch: one graph per B on the card).
"""
from __future__ import annotations

import functools
import io
import json
import os

import numpy as np
import torch

from ..device import resolve_device

MAGIC = b"PTTORCH1"
FORMAT = "paddle_tpu_torch.generator/1"
LAYER_FORMAT = "paddle_tpu_torch.jit/1"
# the reference's artifact magic (`paddle_tpu/jit/__init__.py`)
_REFERENCE_MAGIC = b"PTPUEXP1"
CONFIG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
                 "max_position", "intermediate_size", "layer_norm_epsilon",
                 "tie_embeddings")


# ---------------------------------------------------------------------------
# the artifact pair
# ---------------------------------------------------------------------------

def _to_numpy(t):
    """(array, dtype name for a `dt:` sidecar or None) of a tensor."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).reshape(*t.shape, 2).numpy(), "bfloat16"
    return t.numpy(), None


def write_artifact(path_prefix, params, meta, bufs=None, body=b""):
    """Write the (.pdmodel, .pdiparams) pair: magic, 8-byte header length,
    JSON meta and the program body (none for a generator); params under
    `p:` and buffers under `b:` keys of an npz (bf16 as a uint8 view with
    a `dt:` sidecar). Returns the .pdmodel path."""
    parent = os.path.dirname(path_prefix)
    if parent:
        os.makedirs(parent, exist_ok=True)
    header = json.dumps(meta).encode("utf-8")
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(body)
    arrays = {}
    for tag, tree in (("p:", params), ("b:", bufs or {})):
        for k, v in tree.items():
            a, dt = _to_numpy(v)
            if dt is not None:
                arrays["dt:" + tag + k] = np.frombuffer(dt.encode(),
                                                        dtype=np.uint8)
            arrays[tag + k] = a
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path_prefix + ".pdiparams", "wb") as f:
        f.write(buf.getvalue())
    return path_prefix + ".pdmodel"


def _read(path_prefix, device=None):
    """(params, buffers, meta, program body) of an artifact pair; the
    tensors are uploaded to `device` here, once."""
    dev = resolve_device(device)
    with open(path_prefix + ".pdmodel", "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            what = ("the JAX package's StableHLO artifact, which this "
                    "package cannot run; re-export it with paddle_tpu_torch"
                    if magic == _REFERENCE_MAGIC else
                    f"not a paddle_tpu_torch artifact (magic {magic!r})")
            raise ValueError(f"{path_prefix}.pdmodel is {what}")
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode("utf-8"))
        body = f.read()
    if meta.get("format") not in (FORMAT, LAYER_FORMAT):
        raise ValueError(f"{path_prefix}.pdmodel: unknown format "
                         f"{meta.get('format')!r} (expected {FORMAT!r} or "
                         f"{LAYER_FORMAT!r})")
    trees = {"p:": {}, "b:": {}}
    with open(path_prefix + ".pdiparams", "rb") as f:
        npz = np.load(f, allow_pickle=False)
        for key in npz.files:
            if key[:2] not in trees:
                continue
            t = torch.from_numpy(np.array(npz[key]))
            side = "dt:" + key
            if side in npz.files:
                name = bytes(npz[side]).decode()
                if name != "bfloat16":
                    raise ValueError(f"{key}: unknown dtype sidecar "
                                     f"{name!r}")
                t = t.view(torch.bfloat16).reshape(t.shape[:-1])
            trees[key[:2]][key[2:]] = t.to(dev)
    return trees["p:"], trees["b:"], meta, body


def read_artifact(path_prefix, device=None):
    """(params on `device`, meta) of an artifact pair. Raises on another
    magic (the reference's StableHLO artifact among them) or format."""
    params, _bufs, meta, _body = _read(path_prefix, device)
    return params, meta


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class _Pure(torch.nn.Module):
    """`pure(params, buffers, *xs)`: `fn` over the given state (a layer's
    forward by `functional_call`, or any function of the three)."""

    def __init__(self, fn):
        super().__init__()
        self._fn = [fn]  # a list: not a submodule whose state export lifts

    def forward(self, params, bufs, *xs):
        return self._fn[0](params, bufs, *xs)


def _is_free(d):
    return d is None or (isinstance(d, int) and d < 0)


def example_inputs(input_spec, device):
    """(example tensors, dynamic-shape specs) of an input_spec list: a free
    dim (None or -1) of an InputSpec is Dim.AUTO with example size 2 +
    its axis; a tensor or array is taken as it is, static."""
    from ..core import dtype as dtype_mod
    from ..static.program import InputSpec
    from torch.export import Dim

    xs, dyn = [], []
    for s in input_spec:
        if isinstance(s, InputSpec):
            shape = [2 + i if _is_free(d) else int(d)
                     for i, d in enumerate(s.shape)]
            xs.append(torch.zeros(shape, dtype=dtype_mod.convert_dtype(
                s.dtype), device=device))
            dyn.append({i: Dim.AUTO for i, d in enumerate(s.shape)
                        if _is_free(d)} or None)
        elif isinstance(s, (torch.Tensor, np.ndarray)):
            t = torch.as_tensor(s)
            xs.append(t.to(device))
            dyn.append(None)
        else:
            raise TypeError(f"input_spec entry {type(s)} not understood")
    return xs, dyn


def spec_meta(input_spec, xs):
    """[[shape with None for a free dim, dtype name], ...] for the meta."""
    from ..static.program import InputSpec
    out = []
    for s, x in zip(input_spec, xs):
        shape = [None if _is_free(d) else int(d) for d in s.shape] \
            if isinstance(s, InputSpec) else list(x.shape)
        out.append([shape, str(x.dtype).replace("torch.", "")])
    return out


def export_pure(fn, params, bufs, xs, dyn):
    """The serialized `torch.export` of `fn(params, bufs, *xs)`."""
    ds = ({k: None for k in params}, {k: None for k in bufs}, tuple(dyn))
    with torch.no_grad():
        ep = torch.export.export(_Pure(fn), (params, bufs, *xs),
                                 dynamic_shapes=ds)
    ep.example_inputs = None  # else the archive keeps the weights again
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _layer_state(layer):
    params = {k: v.detach() for k, v in layer.named_parameters()}
    bufs = {k: v.detach() for k, v in layer.named_buffers()}
    return params, bufs


def _layer_fn(layer):
    def pure(params, bufs, *xs):
        return torch.func.functional_call(layer, {**params, **bufs}, xs)
    return pure


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save: the layer's eval-mode forward as an exported
    program with its weights (module docstring). input_spec: a list of
    InputSpec (None or -1 for a free dim), tensors or arrays giving the
    forward's inputs. Returns the .pdmodel path."""
    if input_spec is None:
        raise ValueError(
            "jit.save needs input_spec=[InputSpec(shape, dtype), ...] (or "
            "example tensors) to trace the forward for export")
    was_training = layer.training
    layer.eval()
    try:
        params, bufs = _layer_state(layer)
        first = next(iter(params.values()), None)
        dev = first.device if first is not None else resolve_device(None)
        xs, dyn = example_inputs(input_spec, dev)
        body = export_pure(_layer_fn(layer), params, bufs, xs, dyn)
        meta = {"format": LAYER_FORMAT, "kind": "layer",
                "class_name": type(layer).__name__,
                "in_specs": spec_meta(input_spec, xs),
                "params": list(params), "buffers": list(bufs)}
        return write_artifact(path, params, meta, bufs, body)
    finally:
        if was_training:
            layer.train()


def _retarget(gm, device):
    """Rewrite the devices export baked into `gm`'s nodes (factory calls,
    metadata asserts, copies) to `device`."""
    def fix(a):
        if isinstance(a, torch.device) and a != device:
            return device
        if isinstance(a, (list, tuple)):
            return type(a)(fix(x) for x in a)
        return a

    changed = False
    for node in gm.graph.nodes:
        args, kwargs = fix(node.args), {k: fix(v)
                                        for k, v in node.kwargs.items()}
        if args != node.args or kwargs != node.kwargs:
            node.args, node.kwargs = args, kwargs
            changed = True
    if changed:
        gm.recompile()
    return gm.to(device)


def load_program(body, device):
    """The runnable module of a serialized exported program, on `device`;
    call it as `module(params, bufs, *xs)`."""
    from ..ops import flash_attention  # noqa: F401 — registers the ops
    ep = torch.export.load(io.BytesIO(body))
    return _retarget(ep.module(), torch.device(device))


class TranslatedLayer(torch.nn.Module):
    """A loaded layer or static program (ref: fluid/dygraph/io.py
    TranslatedLayer): the exported program with its weights resident on
    one device, runnable with no model class. `layer(*inputs)` moves the
    inputs to that device and returns what the layer returned."""

    def __init__(self, module, params, bufs, meta):
        super().__init__()
        self._module = [module]
        self._params = params
        self._bufs = bufs
        self._meta = meta

    @property
    def device(self):
        for t in list(self._params.values()) + list(self._bufs.values()):
            return t.device
        return self._device

    @property
    def program(self):
        return self._module[0]

    def run_pure(self, params, bufs, *xs):
        return self._module[0](params, bufs, *xs)

    def forward(self, *args):
        dev = self.device
        xs = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
              .to(dev) for a in args]
        with torch.no_grad():
            return self.run_pure(self._params, self._bufs, *xs)


class TranslatedGenerator:
    """A loaded generator: `layer(ids, seed, temperature, eos, top_p,
    pad)` -> [B, prompt_len + max_new_tokens] int32 CPU tensor (module
    docstring). ids [B, prompt_len] (B fixed by the artifact unless its
    batch_size is None); seed uint32; temperature, top_p floats (top_p
    filters only in an artifact exported with top_p_enabled); eos, pad
    ints (-1 disables; otherwise prompts are LEFT-padded with pad)."""

    def __init__(self, params, meta, cfg):
        from ..models.gpt2_decode import decode_program

        self._params = params
        self._meta = meta
        self.cfg = cfg
        self._program = decode_program(
            cfg, meta["max_new_tokens"], meta["top_k"],
            meta["top_p_enabled"], meta["kv_quant"] == "int8")

    @property
    def device(self):
        return self._params["ln_f.weight"].device

    def forward(self, ids, seed, temperature, eos, top_p, pad):
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else ids)
        P, B = self._meta["prompt_len"], self._meta["batch_size"]
        if ids.ndim != 2 or ids.shape[1] != P or (
                B is not None and ids.shape[0] != B):
            raise ValueError(
                f"ids of shape {ids.shape}: this generator takes "
                f"[{'B' if B is None else B}, {P}]")
        out = self._program(self._params, ids, int(seed) & 0xFFFFFFFF,
                            float(temperature), int(eos), float(top_p),
                            int(pad))
        return out.cpu()

    __call__ = forward


def load(path_prefix, device=None, **configs):
    """paddle.jit.load: a runnable `TranslatedLayer` (a layer or a static
    program) or `TranslatedGenerator` from an artifact pair, with no
    model class (module docstring)."""
    params, bufs, meta, body = _read(path_prefix, device)
    kind = meta.get("kind")
    if kind in ("layer", "program"):
        dev = resolve_device(device)
        layer = TranslatedLayer(load_program(body, dev), params, bufs, meta)
        layer._device = dev
        return layer
    if kind != "gpt2_generator":
        raise ValueError(f"{path_prefix}: unknown artifact kind {kind!r}")
    from ..models.gpt2 import GPT2Config
    cfg = GPT2Config(**{k: meta["config"][k] for k in CONFIG_FIELDS})
    return TranslatedGenerator(params, meta, cfg)


# ---------------------------------------------------------------------------
# to_static
# ---------------------------------------------------------------------------

def _reachable_layers(fn):
    """The layers a free function reaches through its globals and its
    closure, with their sublayers."""
    seen, out = set(), []
    cands = [c.cell_contents for c in (getattr(fn, "__closure__", None)
                                       or ()) if _filled(c)]
    code = getattr(fn, "__code__", None)
    if code is not None:
        g = getattr(fn, "__globals__", {})
        cands += [g[n] for n in code.co_names if n in g]
    for c in cands:
        if isinstance(c, torch.nn.Module) and id(c) not in seen:
            for m in c.modules():
                if id(m) not in seen:
                    seen.add(id(m))
                    out.append(m)
    return out


def _filled(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


class StaticFunction:
    """A `to_static` callable (module docstring): a layer's forward, or a
    free function that leaks no buffer writes."""

    def __init__(self, fn, layer=None, input_spec=None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec

    def __get__(self, obj, objtype=None):
        return self if obj is None else functools.partial(self, obj)

    def __call__(self, *args, **kwargs):
        if not ProgramTranslator.enable_to_static:
            return self._call(args, kwargs)
        if self._layer is not None or (args and isinstance(
                args[0], torch.nn.Module)):
            return self._call(args, kwargs)
        # a free function: the buffers it reaches are restored after it
        saved = [(m, n, b.detach().clone())
                 for m in _reachable_layers(self._fn)
                 for n, b in m.named_buffers(recurse=False)
                 if b is not None]
        try:
            return self._call(args, kwargs)
        finally:
            with torch.no_grad():
                for m, n, v in saved:
                    getattr(m, n).copy_(v)

    def _call(self, args, kwargs):
        if self._layer is not None:
            return self._fn(self._layer, *args, **kwargs)
        return self._fn(*args, **kwargs)

    @property
    def code(self):
        import inspect
        try:
            return inspect.getsource(self._fn)
        except OSError:
            return "<source not available>"


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """@paddle.jit.to_static: a layer (its forward) or a function
    (module docstring)."""
    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(type(fn).forward, layer=fn,
                                        input_spec=input_spec)
            return fn
        if getattr(fn, "__not_to_static__", False):
            return fn
        wrapped = StaticFunction(fn, input_spec=input_spec)
        functools.update_wrapper(wrapped, fn, updated=[])
        return wrapped
    if function is not None:
        return deco(function)
    return deco


declarative = to_static  # the 1.x decorator name (ref: fluid/dygraph/jit.py)


def not_to_static(fn):
    fn.__not_to_static__ = True
    return fn


def ignore_module(modules):
    pass


class ProgramTranslator:
    """ref: dygraph_to_static/program_translator.py: `enable(False)` makes
    every to_static callable the plain function."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, flag):
        ProgramTranslator.enable_to_static = bool(flag)


def enable_to_static(flag=True):
    ProgramTranslator.get_instance().enable(flag)


_dy2static_state = {"verbosity": 0, "code_level": 0}


def set_verbosity(level=0, also_to_stdout=False):
    """Dygraph-to-static logging verbosity (ref: logging_utils)."""
    _dy2static_state["verbosity"] = level


def set_code_level(level=100, also_to_stdout=False):
    _dy2static_state["code_level"] = level


class _Dy2StaticModule:
    """paddle.jit.dy2static."""
    set_verbosity = staticmethod(set_verbosity)
    set_code_level = staticmethod(set_code_level)


dy2static = _Dy2StaticModule()


class TracedLayer:
    """ref: fluid/dygraph/jit.py TracedLayer: `trace(layer, inputs)` runs
    the layer through `to_static` and keeps the example inputs, which
    `save_inference_model` exports with."""

    def __init__(self, layer, inputs):
        self._layer = layer
        self._fn = to_static(layer.forward)
        self._example = list(inputs)

    @staticmethod
    def trace(layer, inputs):
        tl = TracedLayer(layer, inputs)
        return tl._fn(*inputs), tl

    def __call__(self, *args):
        return self._fn(*args)

    def save_inference_model(self, path, feed=None, fetch=None):
        return save(self._layer, path, input_spec=self._example)


__all__ = ["to_static", "declarative", "not_to_static", "ignore_module",
           "ProgramTranslator", "enable_to_static", "set_verbosity",
           "set_code_level", "dy2static", "TracedLayer", "StaticFunction",
           "save", "load", "read_artifact", "write_artifact",
           "TranslatedLayer", "TranslatedGenerator", "MAGIC", "FORMAT",
           "LAYER_FORMAT"]
