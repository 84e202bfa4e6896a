"""One CUDA graph per decode dispatch: the port's counterpart of the
reference's jitted `step` and `multistep(k)` (`paddle_tpu/nn/decode.py`,
`_jitted_paged_fns` and `_jitted_multistep`, whose `lax.scan` runs k
decode steps as ONE device program).

`DecodeGraphs` captures the eager function of `PagedDecoder.multistep(k,
mode)` once per key and replays it, so a decode dispatch is one graph
launch whatever k is, where the eager loop launches every kernel of
every step from the host.

  * The key (`graph_key`) is everything that fixes the captured program:
    k, the mode, the decoder's kv dtype, the shape and dtype of every
    argument (`sp`'s entries too: the stop matrix's width is a power of
    two over the longest stop list, so it varies between dispatches),
    and the address of every tensor the graph reads in place: each
    param and each pool leaf. Replaced params or pools are a new key and
    a new capture. An entry holds its params and pool tensors, so the
    addresses a graph was captured with stay allocated while it can be
    replayed. At most `MAX_GRAPHS` entries are kept (the reference's
    `lru_cache(maxsize=64)`); the least recently used goes first.
  * Static buffers: a graph reads tok, pos, active, tables and every
    `sp` entry from buffers of its own. A dispatch copies its arguments
    into them on the current stream and replays. The outputs (toks
    [k, B], stopped [k, B], counts or None) are the graph's own tensors:
    they hold until its next replay, so the caller reads them before it
    dispatches again (the server reads toks and stops back to the host,
    and `SlotParamStore.swap_counts` copies counts into its own buffer).
  * Capture follows PyTorch's recipe: the kernel library is built and
    loaded first, one eager warm-up runs on a side stream on the
    dispatch's own inputs (it writes the same K/V rows the replay then
    writes again, bit for bit), then `torch.cuda.graph` captures with
    thread-local capture, so CUDA calls of other threads do not break
    it. Nothing inside reads the device back to the host.
  * Launch counts: a replay runs no Python, so no kernel wrapper counts
    it. What the wrappers counted while the graph was captured (when
    nothing launched) is taken back after the capture and added on every
    replay (`kernels.add_launches`), so the counts read as the eager
    loop's.

There is no fallback: a capture or replay that fails raises, and the
caller fails the dispatch. Graphs run on the card only.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..ops import kernels

MAX_GRAPHS = 64


def _leaves(kv):
    return (kv.codes, kv.scales) if hasattr(kv, "codes") else (kv,)


def graph_key(k, mode, kv_dtype, params, inputs, kc, vc, sp):
    """The key of one captured decode dispatch: plain Python over tensor
    metadata (reads no tensor data). `inputs` is (tok, pos, active,
    tables); params and the pool leaves enter with their addresses."""
    return (int(k), (bool(mode[0]), bool(mode[1])), kv_dtype,
            str(inputs[0].device),
            tuple((tuple(t.shape), t.dtype) for t in inputs),
            tuple((n, tuple(t.shape), t.dtype) for n, t in sp.items()),
            tuple((n, t.data_ptr(), tuple(t.shape), t.dtype)
                  for n, t in params.items()),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.stride())
                  for t in _leaves(kc) + _leaves(vc)))


class _Graph:
    """One captured dispatch: its graph, static inputs and outputs, the
    launches its capture counted, and the tensors it reads in place."""

    def __init__(self, graph, inputs, sp, outputs, launched, held):
        self.graph = graph
        self.inputs = inputs
        self.sp = sp
        self.outputs = outputs
        self.launched = launched
        self.held = held

    def replay(self, inputs, sp):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        for name, dst in self.sp.items():
            dst.copy_(sp[name])
        self.graph.replay()
        kernels.add_launches(self.launched)
        return self.outputs


class DecodeGraphs:
    """The CUDA graph cache of one `PagedDecoder` (see module
    docstring). Call it as `multistep(k, mode)`'s function with k and
    mode first; returns (toks [k, B], stopped [k, B], kc, vc, counts or
    None). `captures` and `replays` count this cache's lifetime
    work."""

    def __init__(self, decoder):
        self._dec = decoder
        self._graphs: OrderedDict = OrderedDict()
        self.captures = 0
        self.replays = 0

    def __len__(self):
        return len(self._graphs)

    def __call__(self, k, mode, params, tok, pos, active, tables, kc, vc,
                 sp):
        if not tok.is_cuda:
            raise ValueError(f"decode graphs run on the card: tok is on "
                             f"{tok.device} (call the decoder's eager "
                             f"functions on the CPU)")
        self._dec._check_kv(kc, vc)
        inputs = (tok, pos, active, tables)
        key = graph_key(k, mode, self._dec.kv_dtype, params, inputs, kc,
                        vc, sp)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(k, mode, params, inputs, kc, vc, sp)
            self._graphs[key] = entry
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        toks, stopped, counts = entry.replay(inputs, sp)
        self.replays += 1
        return toks, stopped, kc, vc, counts

    def _capture(self, k, mode, params, inputs, kc, vc, sp):
        multi = self._dec.multistep(k, mode)
        dev = inputs[0].device
        kernels.library()  # the build and load stay outside the capture
        static_in = tuple(t.clone() for t in inputs)
        static_sp = {name: t.clone() for name, t in sp.items()}

        def run():
            return multi(params, *static_in, kc, vc, static_sp)

        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # warm-up: cuBLAS handles and workspaces, lazy inits
        torch.cuda.current_stream(dev).wait_stream(side)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                toks, stopped, _kc, _vc, counts = run()
        finally:  # a capture launches nothing: take its counts back
            after = kernels.launch_counts()
            launched = {n: after[n] - before[n] for n in after
                        if after[n] != before[n]}
            kernels.add_launches({n: -v for n, v in launched.items()})
        self.captures += 1
        held = (tuple(params.values()), kc, vc)
        return _Graph(graph, static_in, static_sp, (toks, stopped, counts),
                      launched, held)


__all__ = ["DecodeGraphs", "graph_key", "MAX_GRAPHS"]
