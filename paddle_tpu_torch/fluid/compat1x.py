"""fluid 1.x top-level helpers: DataFeeder, lod_tensor builders, average,
transpiler-era shims, install_check.

Reference: python/paddle/fluid/{data_feeder,lod_tensor,average,
transpiler/distribute_transpiler,install_check}.py; the port of
`paddle_tpu/fluid/compat1x.py`. Real behavior where the
feature exists on this stack; loud, guided errors where it was superseded
(the distribute transpiler's role is played by fleet + distributed/ps).
"""
from __future__ import annotations

import warnings

import numpy as np

import torch

from ..core.tensor import to_tensor


class DataFeeder:
    """Convert per-sample python data into an Executor feed dict
    (ref: data_feeder.py DataFeeder.feed). LoD-free: variable-length
    fields must be pre-padded, matching the static-shape contract."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [
            v if isinstance(v, str) else getattr(v, "name", str(v))
            for v in feed_list]
        self.place = place

    def feed(self, iterable):
        columns = {name: [] for name in self.feed_names}
        for row in iterable:
            if len(row) != len(self.feed_names):
                raise ValueError(
                    f"each sample must have {len(self.feed_names)} fields "
                    f"({self.feed_names}), got {len(row)}")
            for name, val in zip(self.feed_names, row):
                columns[name].append(np.asarray(val))
        return {name: np.stack(vals) for name, vals in columns.items()}


def _seq_tensor(data, recursive_seq_lens, place):
    """A tensor of `data` on `place` carrying the sequence lengths a 1.x
    LoDTensor carried (`seq_lens`, `recursive_sequence_lengths()`)."""
    t = to_tensor(data, place=place)
    t.seq_lens = recursive_seq_lens
    t.recursive_sequence_lengths = lambda: t.seq_lens
    return t


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """LoD retired: variable-length data is padded/masked (SURVEY §2 #42
    design decision). Build the padded batch; lengths are returned via
    a .seq_lens attribute / recursive_sequence_lengths() for masks."""
    if torch.is_tensor(data):
        data = data.detach().cpu().numpy()
    if isinstance(data, np.ndarray):
        return _seq_tensor(data, recursive_seq_lens, place)
    if isinstance(data, list):
        lens = recursive_seq_lens[-1]
        rows = []
        width = max(int(l) for l in lens) if lens else 0
        flat = [np.asarray(x).reshape(-1) for x in data]
        flat = np.concatenate(flat) if flat else np.zeros(0)
        off = 0
        for l in lens:
            row = np.zeros(width, dtype=flat.dtype)
            row[: int(l)] = flat[off: off + int(l)]
            off += int(l)
            rows.append(row)
        return _seq_tensor(np.stack(rows) if rows else np.zeros((0, 0)),
                           recursive_seq_lens, place)
    raise TypeError(f"unsupported data type {type(data)}")


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    # reference shape contract: [sum(seq_lens)] + base_shape (lod_tensor.py
    # create_random_int_lodtensor) — the ndarray path preserves it
    lens = recursive_seq_lens[-1]
    total = int(sum(lens))
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape))
    return create_lod_tensor(data, recursive_seq_lens, place)


class WeightedAverage:
    """Host-side running weighted average (ref: average.py:40)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        self.numerator += float(np.asarray(value).mean()) * float(weight)
        self.denominator += float(weight)

    def eval(self):
        if self.denominator == 0:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator


class DistributeTranspilerConfig:
    """Accepted for signature compat; consumed by nothing — the PS design
    lives in fleet + distributed/ps (see DistributeTranspiler)."""
    slice_var_up = True
    split_method = None
    min_block_size = 8192
    sync_mode = True


class DistributeTranspiler:
    """The 1.x program-rewriting parameter-server transpiler is superseded
    on this stack: sparse PS training is `paddle.distributed.ps`
    (SparseTable/PSEmbedding) + fleet roles, dense data-parallel is mesh
    sharding. Raising shim with migration guidance (same form as the ONNX
    drop, SURVEY §2 #39)."""

    def __init__(self, config=None):
        raise NotImplementedError(
            "DistributeTranspiler program rewriting was superseded by "
            "the port's parallelism: use paddle.distributed.fleet (init + "
            "distributed_optimizer) for data/hybrid parallel, and "
            "paddle.distributed.ps (SparseTable, PSEmbedding) for "
            "parameter-server sparse training. See examples/recsys_ps.py.")


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    # deprecated no-op in the reference too (memory_optimization_
    # transpiler.py:18) — torch's caching allocator plans memory here
    warnings.warn(
        "fluid.memory_optimize is deprecated and a no-op; torch's caching "
        "allocator plans device memory",
        stacklevel=2)


def release_memory(input_program, skip_opt_set=None):
    warnings.warn(
        "fluid.release_memory is deprecated and a no-op",
        stacklevel=2)


def run_check():
    """fluid.install_check.run_check(): train one tiny layer end-to-end on
    the default device and report (ref: install_check.py:47)."""
    from .. import device, nn, optimizer
    lin = nn.Linear(2, 1)
    opt = optimizer.SGD(learning_rate=0.1,
                        parameters=lin.parameters())
    x = to_tensor(np.random.rand(4, 2).astype(np.float32))
    loss = (lin(x) ** 2).mean()
    loss.backward()
    opt.step()
    print(f"Your Paddle works well on "  # cli-print: install check
          f"{device.get_device().upper()}.")
    print("Your Paddle is installed successfully!")  # cli-print
