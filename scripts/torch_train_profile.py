#!/usr/bin/env python3
"""Where the training time goes on the card, for the PyTorch/CUDA port.

Runs the step of chip_smoke.py phase 6 (`--model gpt2_small`, the
default: GPT-2 small, random weights from a seed, dropout 0, batch
16 x 1024 from np.random.RandomState(0)), phase 6b (`--model
bert_large`: BERT-large pretraining on a batch of 16 x 512 padded to
lengths in 128-512, MLM + NSP, through the per-key-bias flash kernels) or
phase 6c (`--model gpt2_long`: GPT-2 small with max_position 16384 at
1 x 16384, through the two-pass backward K7/K8; `--model
gpt2_long_padded`: 2 x 16384 padded to lengths 16384 and 10240, through
their bias variants) —
the reference bench's mixed-precision step: bf16 compute on float32
masters, AdamW lr 1e-4, wd 0.01: warm steps, measured steps timed with
CUDA events and the host clock (ending in a synchronize), then a few
steps under torch.profiler (CPU + CUDA activities). Prints, with the
card's name and power limit:

  * ms per step, tokens/s, the device time per profiled step summed
    over all kernels, and the device's idle share (1 - busy / unprofiled
    step time; the step runs on one stream, so kernels do not overlap);
  * device time per step by class: the port's flash kernels K4
    (flash_fwd_sm90_kernel in bf16, flash_fwd_kernel in float32; its
    bias variant on BERT and padded batches), K6
    (flash_delta_kernel), K7 (flash_bwd_dq_kernel) and K8
    (flash_bwd_dkv_kernel) past the two-pass switch, and K9
    (flash_bwd_sm90_kernel in bf16, flash_bwd_kernel in float32, with its
    dq scale_cast_kernel; bias variant on BERT); the GEMMs
    (cuBLAS/CUTLASS), with those cuBLAS serves from
    narrow-alignment (align1/align2) kernels apart — the odd-vocab heads'
    products; copies
    and casts (the .contiguous() copies of q, k, v and of the output
    gradient, the bf16 casts of the masters); the softmax/loss kernels;
    the optimizer's foreach kernels; everything else (elementwise, layer
    norm, embedding);
  * per step: the launches of each port kernel and the count of
    aten::clone calls (the copies .contiguous() makes);
  * the top kernels by device time.

Usage (on a machine with the card, from the repo root):
    python3 scripts/torch_train_profile.py [--model gpt2_small|bert_large|
        gpt2_long|gpt2_long_padded] [--steps 5] [--profile-steps 3]
"""
import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("K4 flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("K6 flash_delta", ("flash_delta_kernel",)),
    ("K7 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K8 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K9 flash_bwd", ("flash_bwd_kernel", "flash_bwd_sm90_kernel",
                      "scale_cast_kernel")),
    ("GEMM, narrow alignment (align1/align2)", ("align1", "align2")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "splitKreduce")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("softmax / loss", ("softmax", "nll_loss", "gather")),
    ("copy / cast", ("copy",)),
)


def classify(name):
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other (elementwise, layer norm, embedding)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("gpt2_small", "bert_large",
                                        "gpt2_long", "gpt2_long_padded"),
                    default="gpt2_small")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from paddle_tpu_torch.models import BertConfig, GPT2Config
    from paddle_tpu_torch.ops import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if args.model == "bert_large":
        cfg = BertConfig.large()
        cfg.dropout = 0.0
        B, S = 16, 512
        batch = chip_smoke.bert_batch(torch, cfg,
                                      chip_smoke.bert_lengths(B, S), S, 0,
                                      "cuda")
        step = chip_smoke.bert_amp_train_step(torch, cfg, batch)
        title = "BERT-large (padded, MLM + NSP)"
    elif args.model.startswith("gpt2_long"):
        cfg = GPT2Config(max_position=16384, dropout=0.0)
        padded = args.model == "gpt2_long_padded"
        B, S = (2, 16384) if padded else (1, 16384)
        lengths = [16384, 10240] if padded else None
        step = chip_smoke.amp_train_step(
            torch, cfg, chip_smoke._batch(torch, cfg, B, S, 0, "cuda",
                                          lengths))
        title = ("GPT-2 small, long context"
                 + (" (padded to 16384/10240)" if padded else ""))
    else:
        cfg = GPT2Config(dropout=0.0)
        B, S = 16, 1024
        step = chip_smoke.amp_train_step(
            torch, cfg, chip_smoke._batch(torch, cfg, B, S, 0, "cuda"))
        title = "GPT-2 small"
    for _ in range(2):                                   # warm steps
        step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.steps):                          # measured steps
        loss = step()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    ms = start.elapsed_time(end) / args.steps
    counts = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profile_steps):              # profiled steps
            step()
        torch.cuda.synchronize()
    n = args.profile_steps
    rows, clones = [], 0
    for ev in prof.key_averages():
        if ev.key == "aten::clone":
            clones = ev.count
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / n, ev.count / n, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3  # ms per step
    print(f"card: {card}")
    print(f"{title} B{B} S{S} bf16 on float32 masters, AdamW: "
          f"{ms:.2f} ms/step (CUDA events; host clock {wall * 1e3:.2f} "
          f"ms), tokens_per_sec {B * S / (ms / 1e3):.1f}, last loss "
          f"{loss.item():.4f}")
    if busy == 0:
        print("FAIL: the profiler recorded no device time")
        return 1
    print(f"device busy {busy:.2f} ms/step (profiled), device idle share "
          f"{1 - busy / ms:.3f}")
    launched = {k: v / args.steps for k, v in counts.items() if v}
    print(f"per step: port kernel launches {launched}; aten::clone "
          f"(.contiguous() copies) {clones / n:.0f}; kernels launched "
          f"{sum(r[1] for r in rows):.0f}")
    by_class = {}
    for us, cnt, key in rows:
        c = by_class.setdefault(classify(key), [0.0, 0.0])
        c[0] += us
        c[1] += cnt
    for cls, (us, cnt) in sorted(by_class.items(), key=lambda x: -x[1][0]):
        print(f"  {cls:44s} {us / 1e3:8.2f} ms/step {us / 1e3 / busy:6.3f} "
              f"x{cnt:.0f}")
    print("top kernels (ms/step, share, launches/step):")
    for us, cnt, key in rows[:20]:
        print(f"  {us / 1e3:8.3f} {us / 1e3 / busy:6.3f} x{cnt:<5.0f} "
              f"{key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
