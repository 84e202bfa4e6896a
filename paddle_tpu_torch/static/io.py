"""Inference models of a static Program, the port of
`paddle_tpu/static/io.py` (ref: python/paddle/fluid/io.py:1198
save_inference_model / load_inference_model).

`save_inference_model` exports the Program's forward, `pure(params,
buffers, *feeds) -> fetches` — the Executor's replay (`forward_env`) of
the ops the fetches need (`prune`) — with `torch.export`, into the same artifact pair as
`jit.save` (kind "program", with the feed and fetch names in the meta).
A feed dim declared None is `Dim.AUTO`, so the loaded program is
batch-polymorphic on it. `load_inference_model` returns a
`LoadedProgram`, runnable standalone (`loaded({name: array})`) or
through `Executor.run`, with no Program rebuilt.
"""
from __future__ import annotations

from .. import jit
from ..device import resolve_device
from .executor import _Constants, forward_env, global_scope, prune
from .program import InputSpec, Variable, default_main_program


class LoadedProgram:
    """A loaded inference artifact (the reference's returned
    inference_program): `fetches = loaded(feed_dict)`, or
    `Executor.run(loaded, feed=..., fetch_list=...)`."""

    def __init__(self, layer, meta):
        self._layer = layer
        self.feed_names = list(meta["feed_names"])
        self.fetch_names = list(meta["fetch_names"])

    def __call__(self, feed):
        outs = self._layer(*[feed[n] for n in self.feed_names])
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None, **kwargs):
    """Export the Program's forward from the feeds to the fetches, with
    the persistables of the global scope (module docstring). Returns the
    .pdmodel path."""
    program = program or default_main_program()
    scope = global_scope()
    feed_names = [v.name if isinstance(v, Variable) else str(v)
                  for v in feed_vars]
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in fetch_vars]
    block = program.global_block()
    params = {v.name: scope.find_var(v.name) for v in block.vars.values()
              if v.persistable and scope.find_var(v.name) is not None}
    dev = getattr(executor, "device", None) or resolve_device(None)
    params = {n: t.detach().to(dev) for n, t in params.items()}
    specs = [InputSpec(block.var(n).desc_shape, block.var(n).dtype)
             for n in feed_names]
    xs, dyn = jit.example_inputs(specs, dev)
    consts = _Constants(dev)
    ops = prune(program, fetch_names)

    def pure(params, bufs, *feeds):
        env = forward_env(program, {**params, **dict(zip(feed_names,
                                                         feeds))}, consts,
                          ops)
        return tuple(env[n] for n in fetch_names)

    body = jit.export_pure(pure, params, {}, xs, dyn)
    meta = {"format": jit.LAYER_FORMAT, "kind": "program",
            "feed_names": feed_names, "fetch_names": fetch_names,
            "in_specs": jit.spec_meta(specs, xs), "params": list(params),
            "buffers": []}
    return jit.write_artifact(path_prefix, params, meta, {}, body)


def load_inference_model(path_prefix, executor, **kwargs):
    """(LoadedProgram, feed names, fetch names) of an artifact written by
    `save_inference_model`, on the executor's device; the scope is primed
    with its parameters, as the reference's."""
    dev = getattr(executor, "device", None)
    loaded = jit.load(path_prefix, device=dev)
    scope = global_scope()
    for name, v in loaded._params.items():
        scope.set(name, v)
    prog = LoadedProgram(loaded, loaded._meta)
    return prog, prog.feed_names, prog.fetch_names


__all__ = ["save_inference_model", "load_inference_model", "LoadedProgram"]
