#!/usr/bin/env python3
"""Phase 5's serving traffic on two trees of the port, in turns.

Serves the k = 1 workload of chip_smoke.py phase 5 (GPT-2 small in
bfloat16, random weights from seed 0; PagedGenerationServer(max_slots=8,
block_size=16, max_prompt_len=768, max_new_tokens=32,
prefill_chunk_tokens=512); 16 prompts of 64-768 tokens drawn from
np.random.RandomState(7)) with telemetry off, in `--pairs` pairs of
runs, one run on each tree, alternating which tree runs first (A B, B A,
A B, ...), so that drift within the call falls on both trees. Each run
is a process of its own that imports `paddle_tpu_torch` from its tree
(a checkout, such as a commit unpacked with `git archive`) and builds
that tree's kernels. A run serves a warm pass, then `--passes` measured
passes, each after `reset_stats` and timed on the host clock to a
synchronize; the run's value is the median of its passes.

Prints, beside the card's name and power limit, every run's tokens/s,
TTFT p50 and wall; then for each metric the two trees' medians over
their runs, A's quartile spread, B / A, and the pairs in which B was
better, worse or tied.

Usage (on a machine with the card, from the repo root):
    python3 scripts/torch_serve_ab.py --a PARENT_DIR [--b .] [--pairs 10]
        [--passes 3]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def serve(tree, passes, device="cuda", cfg=None, n_prompts=16):
    """One run: phase 5's server and traffic on `tree`'s package. Returns
    a list of {tokens_per_sec, ttft_p50_ms, wall_ms}, one a measured
    pass."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.models import GPT2, GPT2Config

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        paddle_tpu_torch.__file__)))
    if where != os.path.abspath(tree):
        raise RuntimeError(f"imported paddle_tpu_torch from {where}, not "
                           f"{tree}")
    cfg = cfg or GPT2Config()
    model = GPT2(cfg, seed=0, dtype=torch.bfloat16, device=device)
    rng = np.random.RandomState(7)
    top = min(769, cfg.max_position - 32)
    prompts = [rng.randint(1, cfg.vocab_size,
                           (int(rng.randint(min(64, top - 1), top)),))
               .astype(np.int32) for _ in range(n_prompts)]
    srv = PagedGenerationServer(model, max_slots=8, block_size=16,
                                max_prompt_len=top - 1, max_new_tokens=32,
                                prefill_chunk_tokens=512,
                                device=device).start()
    out = []
    try:
        for f in [srv.submit(p) for p in prompts]:   # warm pass
            f.result(timeout=600)
        for _ in range(passes):
            srv.reset_stats()
            t0 = time.perf_counter()
            for f in [srv.submit(p) for p in prompts]:
                f.result(timeout=600)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = srv.stats()
            out.append({"tokens_per_sec": st["tokens_per_sec"],
                        "ttft_p50_ms": st["ttft_p50_ms"],
                        "wall_ms": wall * 1e3})
    finally:
        srv.stop()
    return out


METRICS = (("tokens_per_sec", True), ("ttft_p50_ms", False),
           ("wall_ms", False))   # (name, higher is better)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", help="tree A (e.g. the parent commit)")
    ap.add_argument("--b", default=".", help="tree B (default: this one)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)  # a run's process
    args = ap.parse_args()
    if args.one:
        print(json.dumps(serve(args.one, args.passes)))
        return 0
    import torch

    if not torch.cuda.is_available() or not args.a:
        print("FAIL: needs a CUDA card and --a")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_METRICS_PORT",
                        "PADDLE_TPU_FAULT_PLAN")}
    runs = {"A": [], "B": []}   # one {metric: median of passes} a run
    for pair in range(args.pairs):
        for tag in ("AB" if pair % 2 == 0 else "BA"):
            tree = args.a if tag == "A" else args.b
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--passes", str(args.passes)],
                capture_output=True, text=True, timeout=900, env=env)
            if p.returncode != 0:
                print(p.stdout[-4000:])
                print(p.stderr[-4000:])
                print(f"FAIL: the run on {tree} exited {p.returncode}")
                return 1
            got = json.loads(p.stdout.strip().splitlines()[-1])
            run = {m: statistics.median(r[m] for r in got)
                   for m, _ in METRICS}
            runs[tag].append(run)
            print(f"pair {pair} {tag} ({tree}), "
                  f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
                      f"{m} " + "/".join(f"{r[m]:.1f}" for r in got)
                      for m, _ in METRICS) + f" [{card}]")
    for m, higher in METRICS:
        a = [r[m] for r in runs["A"]]
        b = [r[m] for r in runs["B"]]
        qa = statistics.quantiles(a, n=4) if len(a) > 1 else [a[0]] * 3
        better = sum((y > x) if higher else (y < x) for x, y in zip(a, b))
        worse = sum((y < x) if higher else (y > x) for x, y in zip(a, b))
        print(f"{m}: median A {statistics.median(a):.2f} B "
              f"{statistics.median(b):.2f}, B / A "
              f"{statistics.median(b) / statistics.median(a):.4f}x; A's "
              f"quartiles {qa[0]:.2f}-{qa[2]:.2f} (spread "
              f"{qa[2] - qa[0]:.2f}); B better in {better}, worse in "
              f"{worse}, tied in {len(a) - better - worse} of {len(a)} "
              f"pairs [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
