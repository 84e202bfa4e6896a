"""Fleet metrics: the port of `paddle_tpu/distributed/fleet/metrics.py`.

Each function all-reduces a host-side accumulator over the world (the
reference's MPI reduce) and finishes the statistic locally. The
reduction runs over torch.distributed's world (on the CPU: a gloo world
reduces host tensors; an NCCL world's values go through the rank's
card); without an initialised process group it is the identity, the
reference on one worker. A failing reduction raises: a per-worker value
reported as the global one would be wrong silently.
"""
from __future__ import annotations

import numpy as np


def _all_reduce_np(arr, mode="sum"):
    if mode not in ("sum", "max", "min"):
        raise ValueError(f"unsupported reduce mode {mode!r}")
    arr = np.asarray(arr, np.float64)
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return arr
    t = torch.from_numpy(arr.copy())
    if dist.get_backend() == "nccl":
        from ..collective import rank_device
        t = t.to(rank_device())
    op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
          "min": dist.ReduceOp.MIN}[mode]
    dist.all_reduce(t, op=op)
    return t.cpu().numpy()


def _to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sum(input, scope=None):  # noqa: A001,A002
    return _all_reduce_np(_to_np(input), "sum")


def max(input, scope=None):  # noqa: A001,A002
    return _all_reduce_np(_to_np(input), "max")


def min(input, scope=None):  # noqa: A001,A002
    return _all_reduce_np(_to_np(input), "min")


def auc(stat_pos, stat_neg, scope=None):
    """ROC AUC from per-bucket positive/negative counters (the trapezoid
    sweep from the top bucket down)."""
    global_pos = _all_reduce_np(_to_np(stat_pos), "sum").reshape(1, -1)
    global_neg = _all_reduce_np(_to_np(stat_neg), "sum").reshape(1, -1)
    num_bucket = global_pos.shape[1]
    area = pos = neg = 0.0
    total_ins_num = 0.0
    for i in range(num_bucket):
        index = num_bucket - 1 - i
        new_pos = pos + global_pos[0][index]
        total_ins_num += global_pos[0][index]
        new_neg = neg + global_neg[0][index]
        total_ins_num += global_neg[0][index]
        area += (new_neg - neg) * (pos + new_pos) / 2
        pos, neg = new_pos, new_neg
    if pos * neg == 0 or total_ins_num == 0:
        return 0.5
    return float(area / (pos * neg))


def mae(abserr, total_ins_num, scope=None):
    # only the error is reduced; total_ins_num is the global count
    err = _all_reduce_np(_to_np(abserr), "sum")
    return float(err.sum() / total_ins_num)


def rmse(sqrerr, total_ins_num, scope=None):
    err = _all_reduce_np(_to_np(sqrerr), "sum")
    return float((err.sum() / total_ins_num) ** 0.5)


def mse(sqrerr, total_ins_num, scope=None):
    err = _all_reduce_np(_to_np(sqrerr), "sum")
    return float(err.sum() / total_ins_num)


def acc(correct, total, scope=None):
    c = _all_reduce_np(_to_np(correct), "sum")
    t = _all_reduce_np(_to_np(total), "sum")
    return float(c.sum() / t.sum())
