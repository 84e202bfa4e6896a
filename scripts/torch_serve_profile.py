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

`--speculation K` serves with `SpecConfig(max_draft_tokens=K)` (the n-gram
drafter) on chip_smoke.py phase 5v (b)'s speculation traffic (bench.py's
speculation axis: 16 repetitive prompts, 64 new tokens, 8 slots,
max_prompt_len 256, recorded and picked as chip_smoke's `spec_axis_pool`
does); `--unified sync|async` runs the unified round (sync) or the async
rounds. Then the host clock is split by the round's parts: the split
round's prefill, verify (`_speculate`: drafting, the verify dispatch and
its processing) and plain decode; the unified round's plan, dispatch and
process. With speculation it also prints the verify dispatches, on the split
round the K1 launches they added (counted around each verify replay),
and, from
chip_smoke's `verify_dispatch_cost` at the served shape (8 rows of
K + 1 tokens, one graph replay), K1's device ms per verify dispatch.

Usage (on a machine with the card, from the repo root):
    python3 scripts/torch_serve_profile.py [--steps-per-dispatch K]
        [--quantization w8a16] [--speculation K] [--unified sync|async]
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
    ap.add_argument("--speculation", type=int, default=0)
    ap.add_argument("--unified", choices=("sync", "async"), default=None)
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
    import chip_smoke
    from paddle_tpu_torch.spec_decode import SpecConfig

    cfg = GPT2Config()
    model = GPT2(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    kw = dict(steps_per_dispatch=args.steps_per_dispatch,
              quantization=args.quantization,
              unified_round=args.unified == "sync",
              async_rounds=args.unified == "async")
    if args.speculation:
        prompts, _refs = chip_smoke.spec_axis_pool(torch, model, card)
        kw["speculation"] = SpecConfig(max_draft_tokens=args.speculation)
        shape = dict(max_slots=8, max_prompt_len=chip_smoke.S_MP,
                     max_new_tokens=chip_smoke.S_NEW)
    else:
        rng = np.random.RandomState(7)
        prompts = [rng.randint(1, cfg.vocab_size,
                               (int(rng.randint(64, 769)),)).astype(np.int32)
                   for _ in range(16)]
        shape = dict(max_slots=8, max_prompt_len=768, max_new_tokens=32)
    srv = PagedGenerationServer(model, block_size=16,
                                prefill_chunk_tokens=512, device="cuda",
                                **shape, **kw).start()
    host = {}  # name -> [seconds, calls] on the host clock
    try:
        for f in [srv.submit(p) for p in prompts]:   # warm pass
            f.result(timeout=600)
        srv.reset_stats()
        timed = [(srv, "_prefill_packed"), (srv, "_decode_plain"),
                 (srv, "_speculate"), (srv, "_plan_round"),
                 (srv, "_dispatch_round"), (srv, "_process_round"),
                 (decode_graph.DecodeGraphs, "__call__"),
                 (decode_graph, "graph_key"),
                 (decode_graph._Graph, "replay")]
        for owner, name in timed:
            setattr(owner, name, _timed(getattr(owner, name), name, host))
        spy = chip_smoke.LaunchSpy(srv._decoder.graphs)

        t0 = time.perf_counter()
        for f in [srv.submit(p) for p in prompts]:   # measured pass
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        measured = {n: list(v) for n, v in host.items()}
        measured_k1 = sum(v for n, v in spy.counts.items()
                          if n.startswith("ragged_stream"))
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
          f"{st['decode_steps']}, speculation {args.speculation}, unified "
          f"{args.unified}, rounds {st['rounds']['rounds']}, attention "
          f"dispatches {st['rounds']['attention_dispatches']}, overlap "
          f"fraction {st['rounds']['overlap_fraction']:.3f}")
    if busy == 0:
        print("FAIL: the profiler recorded no device time")
        return 1
    names = [name for _owner, name in timed]
    sec = {n: measured.get(n, [0.0, 0])[0] for n in names}
    calls = {n: measured.get(n, [0.0, 0])[1] for n in names}

    def part(name, label):
        n = max(calls[name], 1)
        return (f"{label} {sec[name] * 1e3:.1f} ms ({calls[name]} calls, "
                f"{sec[name] * 1e3 / n:.3f} ms a call)")

    if args.unified:
        parts = [("_plan_round", "plan"),
                 ("_dispatch_round", "dispatch (uploads, the round's "
                  "program: a graph replay or the eager mixed round)"),
                 ("_process_round", "process (device waits included)"),
                 ("replay", "of which graph replays (copies + launch)")]
        top = ("_plan_round", "_dispatch_round", "_process_round")
    else:
        parts = [("_prefill_packed", "prefill dispatches"),
                 ("_speculate", "speculation (drafting, the verify "
                  "dispatch and its processing, device waits included)"),
                 ("_decode_plain", "decode dispatches (device waits "
                  "included)"),
                 ("__call__", "of which the decode graph's call"),
                 ("graph_key", "graph keys"),
                 ("replay", "graph replays (copies + launch)")]
        top = ("_prefill_packed", "_speculate", "_decode_plain")
    print("host clock of the measured pass: " + "; ".join(
        part(n, label) for n, label in parts)
        + f"; the rest of the loop "
        f"{(wall - sum(sec[n] for n in top)) * 1e3:.1f} ms")
    if args.speculation:
        sp = st["speculation"]
        cost = chip_smoke.verify_dispatch_cost(torch, model, srv._m_width,
                                               K=args.speculation)
        added = ("" if args.unified else
                 f", K1 launches they added {measured_k1} "
                 f"({measured_k1 / max(sp['verify_dispatches'], 1):.1f} a "
                 f"verify dispatch)")
        print(f"speculation: acceptance_rate {sp['acceptance_rate']:.4f}, "
              f"verify dispatches {sp['verify_dispatches']}{added}; at "
              f"the served shape a verify dispatch "
              f"takes {cost['ms']:.4f} ms (events), device "
              f"{cost['device_ms']:.4f} ms, K1 {cost['k1_ms']:.4f} ms device "
              f"a dispatch")
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
