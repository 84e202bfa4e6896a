#!/usr/bin/env python3
"""The cost of one flash-attention call through two versions of the
port's attention route, in one process, in turns.

Route B is this tree's `paddle_tpu_torch/ops/flash_attention.py`; route
A is another tree's copy of that file (`--a`, e.g. the parent commit
unpacked with `git archive`), loaded beside it as
`paddle_tpu_torch.ops._flash_route_a`, so both routes call the same
kernel library (`ops/kernels.py` must be the same file in both trees;
the script refuses otherwise). What differs is the Python route from
the entry point to the kernel launches: an `autograd.Function`, or a
registered `torch.library` op and its autograd rule.

Each route calls the public entry points (`flash_attention_bias`,
`flash_attention`) in three cases: the bias forward under `no_grad` (K4
bias), the bias forward and backward by `torch.autograd.grad` (K4 bias,
K6, K9 bias), the causal forward and backward (K4, K6, K9); at two
shapes: bfloat16 B 1 x H 12 x S 128 x D 64, small enough that a call's
time is the host's, and float32 B 16 x H 12 x S 512 x D 64, the eager
BERT-base classifier's (chip_smoke.py 6a). A round times one block of
`--calls` calls of a case on each route, A then B, or B then A in every
other round, each block from a synchronize to a synchronize; the host's
time (to the last call's return) and the wall time (to the synchronize)
are both kept, in microseconds a call.

Prints, beside the card's name and power limit, for each shape and case
the two routes' medians over `--rounds` rounds, A's quartile spread,
B - A a call and for 12 and 24 calls a step (one a layer of a 12-layer
model's eager training step; BERT's step makes two), and the rounds in
which B was faster or slower.

Usage (on a machine with the card, from the repo root):
    python3 scripts/torch_flash_dispatch_ab.py --a PARENT_DIR
        [--rounds 12] [--calls 500]
"""
import argparse
import filecmp
import importlib.util
import os
import statistics
import subprocess
import sys
import time

SHAPES = (("small bf16", (1, 12, 128, 64), "bfloat16"),
          ("6a f32", (16, 12, 512, 64), "float32"))
CASES = ("bias_fwd", "bias_fwd_bwd", "causal_fwd_bwd")


def load_route_a(tree):
    """Tree A's ops/flash_attention.py as a module of this package."""
    import paddle_tpu_torch.ops as ops

    here = os.path.dirname(ops.__file__)
    there = os.path.join(tree, "paddle_tpu_torch", "ops")
    if not filecmp.cmp(os.path.join(here, "kernels.py"),
                       os.path.join(there, "kernels.py"), shallow=False):
        raise RuntimeError("ops/kernels.py differs between the trees: the "
                           "routes would call different kernels")
    name = "paddle_tpu_torch.ops._flash_route_a"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(there, "flash_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(torch, route, shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype) for _ in range(4))
    bias = torch.zeros(shape[0], shape[2], device="cuda")
    bias[:, shape[2] * 3 // 4:] = -1e9   # a padded tail
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def bias_fwd():
        with torch.no_grad():
            route.flash_attention_bias(q, k, v, bias)

    def bias_fwd_bwd():
        torch.autograd.grad(route.flash_attention_bias(qg, kg, vg, bias),
                            (qg, kg, vg), do)

    def causal_fwd_bwd():
        torch.autograd.grad(route.flash_attention(qg, kg, vg, causal=True),
                            (qg, kg, vg), do)

    return {"bias_fwd": bias_fwd, "bias_fwd_bwd": bias_fwd_bwd,
            "causal_fwd_bwd": causal_fwd_bwd}


def block(torch, fn, calls):
    """(host, wall) microseconds a call over `calls` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True,
                    help="tree A (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from paddle_tpu_torch.ops import flash_attention as route_b
    from paddle_tpu_torch.ops import kernels

    route_a = load_route_a(os.path.abspath(args.a))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kernels.build()
    kernels.library()
    for label, shape, dtype in SHAPES:
        dt = getattr(torch, dtype)
        fns = {"A": cases(torch, route_a, shape, dt),
               "B": cases(torch, route_b, shape, dt)}
        calls = args.calls if shape[0] == 1 else max(args.calls // 10, 20)
        for case in CASES:
            for tag in "AB":                       # warm-up
                block(torch, fns[tag][case], 20)
            got = {"A": [], "B": []}
            kernels.reset_launch_counts()
            for r in range(args.rounds):
                for tag in ("AB" if r % 2 == 0 else "BA"):
                    got[tag].append(block(torch, fns[tag][case], calls))
            launches = {n: c for n, c in kernels.launch_counts().items()
                        if c}
            parts = []
            for i, what in enumerate(("host", "wall")):
                a = [x[i] for x in got["A"]]
                b = [x[i] for x in got["B"]]
                ma, mb = statistics.median(a), statistics.median(b)
                qa = statistics.quantiles(a, n=4)
                parts.append(
                    f"{what}: A {ma:.2f} B {mb:.2f} us a call, B - A "
                    f"{mb - ma:+.2f} us ({(mb - ma) * 12 / 1e3:+.4f} ms at "
                    f"12 calls a step, {(mb - ma) * 24 / 1e3:+.4f} at 24); "
                    f"A's quartiles {qa[0]:.2f}-{qa[2]:.2f}; B faster in "
                    f"{sum(y < x for x, y in zip(a, b))}, slower in "
                    f"{sum(y > x for x, y in zip(a, b))} of {len(a)} rounds")
            print(f"{label} {tuple(shape)} {case}, {calls} calls a block: "
                  + "; ".join(parts) + f"; launches {launches} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
