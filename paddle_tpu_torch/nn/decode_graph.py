"""One CUDA graph per decode dispatch: the port's counterpart of the
reference's jitted `step`, `multistep(k)`, `packed_verify` and window
`unified_round` (`paddle_tpu/nn/decode.py`: `_jitted_paged_fns`,
`_jitted_multistep`, whose `lax.scan` runs k decode steps as ONE device
program, `_jitted_packed_verify` and `_jitted_unified_round`).

`DecodeGraphs` captures the eager function of one of the decoder's
programs once per key and replays it, so a dispatch is one graph launch,
where the eager function launches every kernel from the host:

  * `graphs(k, mode, *multistep's arguments)`: `multistep(k, mode)`;
  * `graphs.verify(mode, *packed_verify's arguments)`: `packed_verify`,
    whose shapes the verify plan pins (P rows of W tokens, K + 1
    readouts): one capture per sampling mode and stop-matrix width;
  * `graphs.unified(mode, *unified_round's arguments)`: `unified_round(
    window=True)`, the chunk-free round, pinned the same way. The mixed
    round (`window=False`) stays eager: its stream length varies.

  * The key (`graph_key`) is everything that fixes the captured program:
    the program's name, k, the mode, the decoder's kv dtype, the shape
    and dtype of every
    argument (`sp`'s entries too: the stop matrix's width is a power of
    two over the longest stop list, so it varies between dispatches),
    and the address of every tensor the graph reads in place: each
    param and each pool leaf. Replaced params or pools are a new key and
    a new capture. An entry holds its params and pool tensors, so the
    addresses a graph was captured with stay allocated while it can be
    replayed. At most `MAX_GRAPHS` entries are kept (the reference's
    `lru_cache(maxsize=64)`); the least recently used goes first.
  * Static buffers: a graph reads its inputs (multistep: tok, pos,
    active, tables) and every `sp` entry from buffers of its own. A
    dispatch copies its arguments into them on the current stream and
    replays. The outputs (every result but the pools) are the graph's
    own tensors: they hold until its next replay, so the caller reads
    them before it dispatches again, in stream order (the server copies
    tokens and stops to the host or to page-locked buffers, and
    `SlotParamStore.swap_counts` copies counts into its own buffer).
  * Capture follows PyTorch's recipe: the kernel library is built and
    loaded first, one eager warm-up runs on a side stream on the
    dispatch's own inputs (it writes the same K/V rows the replay then
    writes again, bit for bit), then `torch.cuda.graph` captures with
    thread-local capture, so CUDA calls of other threads do not break
    it, and with Python's garbage collector paused, so a dead graph is
    never freed inside another's capture. Nothing inside reads the
    device back to the host.
  * Launch counts: a replay runs no Python, so no kernel wrapper counts
    it. What the wrappers counted while the graph was captured (when
    nothing launched) is taken back after the capture and added on every
    replay (`kernels.add_launches`), so the counts read as the eager
    loop's.

`ProgramGraphs` applies the same rules to a fixed-shape program that
is not the paged decoder's: the dense decode program of
`GPT2.generate(kv_cache="dense")` and of the exported generator
(`models/gpt2_decode.py`, the reference's prefill and `lax.scan` of
`_build_decode_fn`), captured whole as one graph per key.

Every capture is recorded with the capture tracker
(`observability.compile_tracker.record`): the program's name
(`multistep`, `packed_verify`, `unified_window`, or the first item of
a `ProgramGraphs` key: `dense_decode`, `predictor`), whether a server
had requests in flight, and the seconds the warm-up and the capture
took. The captures are the port's costly first-use events, where the
reference counts XLA compiles (ROADMAP §C 18).

There is no fallback: a capture or replay that fails raises, and the
caller fails the dispatch. Graphs run on the card only.
"""
from __future__ import annotations

import gc
import time
from collections import OrderedDict

import torch

from ..observability import compile_tracker
from ..ops import kernels

MAX_GRAPHS = 64


def _leaves(kv):
    return (kv.codes, kv.scales) if hasattr(kv, "codes") else (kv,)


def graph_key(k, mode, kv_dtype, params, inputs, kc, vc, sp,
              program="multistep"):
    """The key of one captured dispatch: plain Python over tensor
    metadata (reads no tensor data). `program` names the decoder's
    function ("multistep", "packed_verify", "unified_window");
    `inputs` are its tensor arguments but the params, pools and sp
    (multistep: tok, pos, active, tables); params and the pool leaves
    enter with their addresses."""
    return (program, int(k), (bool(mode[0]), bool(mode[1])), kv_dtype,
            str(inputs[0].device),
            tuple((tuple(t.shape), t.dtype) for t in inputs),
            tuple((n, tuple(t.shape), t.dtype) for n, t in sp.items()),
            tuple((n, t.data_ptr(), tuple(t.shape), t.dtype)
                  for n, t in params.items()),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.stride())
                  for t in _leaves(kc) + _leaves(vc)))


class _Graph:
    """One captured dispatch: its graph, static inputs and outputs (every
    result but the pools), the launches its capture counted, and the
    tensors it reads in place."""

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
    mode first, or through `verify` / `unified`; each returns what the
    eager function returns (the pools are the caller's own). `captures`
    and `replays` count this cache's lifetime work."""

    def __init__(self, decoder):
        self._dec = decoder
        self._graphs: OrderedDict = OrderedDict()
        self.captures = 0
        self.replays = 0

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        """Drop every captured graph (with the params and pools it held)
        now, not when a garbage collection finds the decoder: a caller
        whose pools die with it (the offline paged generate) calls this
        once its last replay has been read."""
        self._graphs.clear()

    def __call__(self, k, mode, params, tok, pos, active, tables, kc, vc,
                 sp):
        """`multistep(k, mode)` as one replay: (toks [k, B], stopped
        [k, B], kc, vc, counts or None)."""
        multi = self._dec.multistep(k, mode)
        toks, stopped, counts = self._run(
            "multistep", k, mode, params, (tok, pos, active, tables), kc,
            vc, sp, lambda p, *a: multi(p, *a), kv_at=2)
        return toks, stopped, kc, vc, counts

    def verify(self, mode, params, toks, seg, pos, tables, sample_idx,
               dlen, kc, vc, sp):
        """`packed_verify` as one replay: (vtok, accepted, stopped, kc,
        vc, counts or None)."""
        dec = self._dec

        def fn(p, *a):
            return dec.packed_verify(p, *a, mode)[:6]

        vtok, accepted, stopped, counts = self._run(
            "packed_verify", 1, mode, params,
            (toks, seg, pos, tables, sample_idx, dlen), kc, vc, sp, fn,
            kv_at=3)
        return vtok, accepted, stopped, kc, vc, counts

    def unified(self, mode, params, toks, seg, pos, tables, sample_idx,
                dlen, row_slot, carry_map, pos_map, steps_map, carry_tok,
                carry_pos, carry_steps, kc, vc, sp):
        """`unified_round(window=True)` as one replay: (vtok, accepted,
        stopped, kc, vc, counts or None, carry_tok, carry_pos,
        carry_steps)."""
        dec = self._dec

        def fn(p, *a):
            return dec.unified_round(p, *a, mode, window=True)[:9]

        vtok, accepted, stopped, counts, ct, cp, cs = self._run(
            "unified_window", 1, mode, params,
            (toks, seg, pos, tables, sample_idx, dlen, row_slot, carry_map,
             pos_map, steps_map, carry_tok, carry_pos, carry_steps), kc,
            vc, sp, fn, kv_at=3)
        return vtok, accepted, stopped, kc, vc, counts, ct, cp, cs

    def _run(self, program, k, mode, params, inputs, kc, vc, sp, fn, kv_at):
        """Replay (capturing first when the key is new) `fn(params,
        *inputs, kc, vc, sp)`; returns its results but the two pools,
        which sit at `kv_at`."""
        if not inputs[0].is_cuda:
            raise ValueError(f"decode graphs run on the card: the inputs "
                             f"are on {inputs[0].device} (call the "
                             f"decoder's eager functions on the CPU)")
        self._dec._check_kv(kc, vc)
        key = graph_key(k, mode, self._dec.kv_dtype, params, inputs, kc,
                        vc, sp, program)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(program, params, inputs, kc, vc, sp, fn,
                                  kv_at)
            self._graphs[key] = entry
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        outputs = entry.replay(inputs, sp)
        self.replays += 1
        return outputs

    def _capture(self, program, params, inputs, kc, vc, sp, fn, kv_at):
        t0 = time.perf_counter()
        static_in = tuple(t.clone() for t in inputs)
        static_sp = {name: t.clone() for name, t in sp.items()}

        def run():
            out = fn(params, *static_in, kc, vc, static_sp)
            return tuple(out[:kv_at]) + tuple(out[kv_at + 2:])

        graph, outputs, launched = capture(run, inputs[0].device)
        self.captures += 1
        compile_tracker.record(program, time.perf_counter() - t0)
        held = (tuple(params.values()), kc, vc)
        return _Graph(graph, static_in, static_sp, outputs, launched, held)


def capture(run, dev, load_kernels=True):
    """Capture `run()` (no arguments; it reads static tensors) as one CUDA
    graph on `dev` by PyTorch's recipe: the kernel library is built and
    loaded first (`load_kernels`; a program that launches none of the
    port's kernels skips it), one eager warm-up runs on a side stream, then
    `torch.cuda.graph` captures with thread-local capture. Returns
    (graph, run's outputs as captured, the launches the kernel wrappers
    counted during the capture, which is taken back from the counts)."""
    if load_kernels:  # the build and load stay outside the capture
        kernels.library()
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run()  # warm-up: cuBLAS handles and workspaces, lazy inits
    torch.cuda.current_stream(dev).wait_stream(side)
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    # no garbage collection during the capture: a dead reference cycle
    # holding another graph (a decoder and its graph cache) freed there
    # would release that graph's memory pool mid-capture and invalidate
    # this capture; the cycle is collected after it
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = run()
    finally:  # a capture launches nothing: take its counts back
        if gc_was_on:
            gc.enable()
        after = kernels.launch_counts()
        launched = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        kernels.add_launches({n: -v for n, v in launched.items()})
    return graph, outputs, launched


class ProgramGraphs:
    """CUDA graphs of one fixed-shape program `fn(params, *inputs) ->
    tuple of tensors` (the dense decode program of
    `models/gpt2_decode.py`, or an exported program of
    `inference.Predictor`, whose kernels the warm-up builds and loads
    before the capture), one per key: the caller's key (a tuple whose
    first item names the program, then what fixes it: its static
    arguments) plus the
    shape and dtype of every input, the device and the address of every
    param, as `graph_key`.
    The inputs are copied into the graph's static buffers before each
    replay; the outputs are the graph's own tensors, overwritten by its
    next replay (the caller copies them out first). At most
    `MAX_GRAPHS` entries, least recently used first out. A capture or
    replay that fails raises."""

    def __init__(self):
        self._graphs: OrderedDict = OrderedDict()
        self.captures = 0
        self.replays = 0

    def __len__(self):
        return len(self._graphs)

    def __call__(self, key, fn, params, inputs):
        if not inputs[0].is_cuda:
            raise ValueError(f"program graphs run on the card: the inputs "
                             f"are on {inputs[0].device}")
        full = (key, str(inputs[0].device),
                tuple((tuple(t.shape), t.dtype) for t in inputs),
                tuple((n, t.data_ptr(), tuple(t.shape), t.dtype)
                      for n, t in params.items()))
        entry = self._graphs.get(full)
        if entry is None:
            t0 = time.perf_counter()
            static_in = tuple(t.clone() for t in inputs)
            graph, outputs, launched = capture(
                lambda: fn(params, *static_in), inputs[0].device,
                load_kernels=False)
            self.captures += 1
            compile_tracker.record(key[0], time.perf_counter() - t0)
            entry = _Graph(graph, static_in, {}, outputs, launched,
                           tuple(params.values()))
            self._graphs[full] = entry
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(full)
        outputs = entry.replay(inputs, {})
        self.replays += 1
        return outputs


__all__ = ["DecodeGraphs", "ProgramGraphs", "capture", "graph_key",
           "MAX_GRAPHS"]
