#!/usr/bin/env python3
"""Where the serving time goes on the card, for the PyTorch/CUDA port.

Serves the same workload as phase 5 of chip_smoke.py (GPT-2 small in
bfloat16, random weights from a seed; PagedGenerationServer(max_slots=8,
block_size=16, max_prompt_len=768, max_new_tokens=32,
prefill_chunk_tokens=512); 16 prompts of 64-768 tokens drawn from
np.random.RandomState(7)): a warm pass, a measured pass timed on the
host clock (ending in a synchronize), and the same pass again under
torch.profiler (CPU + CUDA activities), whose host tracing slows the
loop but not the kernels. Prints, with the card's name and power limit:

  * the measured pass's wall time and stats, the device time summed
    over all kernels of the profiled pass, and the device's idle share
    (1 - busy / unprofiled wall; kernels on one stream do not overlap);
  * device time by kernel name (top 15), with each one's share;
  * where the measured pass's wall time goes on the host clock: inside
    the packed prefill dispatches, inside the decode dispatches (device
    waits included) and, within those, the decode graph's call (its key
    and its replay: static copies and the graph launch), and the rest
    of the loop (admission, bookkeeping, waiting for work);
  * the share of the port's own kernels in the device time: K1 (every
    kernel whose name starts with `ragged_stream`: the bf16
    `ragged_stream_sm90_kernel` serving runs, and the float32 SIMT
    `ragged_stream_kernel`), with its launches and device ms per packed
    prefill, and K2 (every kernel whose name starts with `paged_decode`:
    the split kernel and its combine), with K2's launches and device ms
    per decode step of the profiled pass.

Usage (on a machine with the card, from the repo root):
    python3 scripts/torch_serve_profile.py [--steps-per-dispatch K]
        [--quantization w8a16]
"""
import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# a K1 or K2 kernel's name, as the demangled key gives it (after "::" or a
# space)
K1_NAME = re.compile(r"(?:^|[\s:])ragged_stream\w*")
K2_NAME = re.compile(r"(?:^|[\s:])paged_decode\w*")


def _timed(fn, name, acc):
    """`fn` adding its host-clock seconds and calls to acc[name]."""
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            rec = acc.setdefault(name, [0.0, 0])
            rec[0] += time.perf_counter() - t0
            rec[1] += 1
    return wrapped


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    ap.add_argument("--quantization", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.models import GPT2, GPT2Config
    from paddle_tpu_torch.nn import decode_graph

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cfg = GPT2Config()
    model = GPT2(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size,
                           (int(rng.randint(64, 769)),)).astype(np.int32)
               for _ in range(16)]
    srv = PagedGenerationServer(
        model, max_slots=8, block_size=16, max_prompt_len=768,
        max_new_tokens=32, prefill_chunk_tokens=512,
        steps_per_dispatch=args.steps_per_dispatch,
        quantization=args.quantization, device="cuda").start()
    host = {}  # name -> [seconds, calls] on the host clock
    try:
        for f in [srv.submit(p) for p in prompts]:   # warm pass
            f.result(timeout=600)
        srv.reset_stats()
        for owner, name in ((srv, "_prefill_packed"), (srv, "_decode_plain"),
                            (decode_graph.DecodeGraphs, "__call__"),
                            (decode_graph, "graph_key"),
                            (decode_graph._Graph, "replay")):
            setattr(owner, name, _timed(getattr(owner, name), name, host))
        t0 = time.perf_counter()
        for f in [srv.submit(p) for p in prompts]:   # measured pass
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        measured = {n: list(v) for n, v in host.items()}
        srv.reset_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in [srv.submit(p) for p in prompts]:   # profiled pass
                f.result(timeout=600)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        st_prof = srv.stats()
    finally:
        srv.stop()
    rows = []  # device-side events only (kernels, copies, sets): the
    # host ops that launched them would count the same time twice
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"card: {card}")
    print(f"steps_per_dispatch {args.steps_per_dispatch}: wall "
          f"{wall * 1e3:.1f} ms (profiled pass {wall_prof * 1e3:.1f} ms), "
          f"device busy {busy * 1e3:.1f} ms, device idle share "
          f"{1 - busy / wall:.3f}; tokens_per_sec "
          f"{st['tokens_per_sec']:.1f}, itl p50 {st['itl_p50_ms']:.2f} ms, "
          f"ttft p50 {st['ttft_p50_ms']:.1f} ms, prefill_dispatches "
          f"{st['prefill_dispatches']}, decode dispatches "
          f"{st['decode_steps']}")
    if busy == 0:
        print("FAIL: the profiler recorded no device time")
        return 1
    names = ("_prefill_packed", "_decode_plain", "__call__", "graph_key",
             "replay")
    sec = {n: measured.get(n, [0.0, 0])[0] for n in names}
    calls = {n: measured.get(n, [0.0, 0])[1] for n in names}

    def part(name, label):
        n = max(calls[name], 1)
        return (f"{label} {sec[name] * 1e3:.1f} ms ({calls[name]} calls, "
                f"{sec[name] * 1e3 / n:.3f} ms a call)")

    print("host clock of the measured pass: " + "; ".join([
        part("_prefill_packed", "prefill dispatches"),
        part("_decode_plain", "decode dispatches (device waits included)"),
        part("__call__", "of which the decode graph's call"),
        part("graph_key", "its key"),
        part("replay", "its replay (copies + launch)")])
        + f"; the rest of the loop "
        f"{(wall - sec['_prefill_packed'] - sec['_decode_plain']) * 1e3:.1f}"
        f" ms")
    # K1 is every kernel whose name starts with ragged_stream (either
    # dtype's); K2 every one whose name starts with paged_decode (the split
    # kernel and its combine)
    k1 = k2 = 0.0
    k1_launches = k2_launches = 0
    for us, n, key in rows:
        if K1_NAME.search(key):
            k1 += us / 1e6
            k1_launches += n
        elif K2_NAME.search(key):
            k2 += us / 1e6
            k2_launches += n
    steps = st_prof["decode_steps"] * args.steps_per_dispatch
    prefills = st_prof["prefill_dispatches"]
    print(f"K1 ragged_stream* {k1 * 1e3:.1f} ms ({k1 / busy:.3f} of "
          f"device time), {k1_launches} launches, "
          f"{k1 * 1e3 / max(prefills, 1):.4f} ms per packed prefill "
          f"({prefills} prefills); K2 paged_decode* {k2 * 1e3:.1f} ms "
          f"({k2 / busy:.3f}), {k2_launches} launches, "
          f"{k2 * 1e3 / max(steps, 1):.4f} ms per decode step "
          f"({steps} steps)")
    for us, n, key in rows[:15]:
        print(f"  {us / 1e3:9.2f} ms {us / 1e6 / busy:6.3f} x{n:<6d} "
              f"{key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
