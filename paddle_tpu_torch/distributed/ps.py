"""Host-resident sparse embedding tables (parameter-server mode): the
port of `paddle_tpu/distributed/ps.py`.

Paddle's PS mode keeps large recsys embedding tables on server processes;
trainers pull rows, compute, and push sparse gradients back. Here, as in
the reference, the "server" is host memory: a `SparseTable` is a numpy
[rows, dim] array (sgd or adagrad updates, rows routed to shards by
`row % num_shards`), and only the pulled minibatch of rows travels to the
device.

  SparseTable   — the host table (pull, push, state_dict)
  PSEmbedding   — an nn.Module: forward pulls the rows of `ids` onto its
                  device as a leaf that takes a gradient; after the
                  backward, `apply_gradients()` pushes those gradients to
                  the table. Its device is the first card unless
                  `device="cpu"` is passed.
  the role API  — init_server / run_server / init_worker / stop_worker /
                  save_persistables over the process's table registry
                  (`fleet.init_server()` etc. call these)
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


class SparseTable:
    """Host-resident [rows, dim] embedding table with sparse updates.

    Updates are applied with np.add.at (duplicate ids accumulate: the
    sum-merge of sparse gradients).
    """

    def __init__(self, rows, dim, init_std=0.01, optimizer="sgd",
                 learning_rate=0.1, seed=0, num_shards=1, shard_id=0):
        self.rows, self.dim = rows, dim
        self.num_shards, self.shard_id = num_shards, shard_id
        rng = np.random.RandomState(seed)
        # each shard materializes only its own rows (row % num_shards ==
        # shard_id); a dense local index maps global row -> local slot
        self._global_rows = np.arange(shard_id, rows, num_shards)
        self.data = (rng.randn(len(self._global_rows), dim) * init_std) \
            .astype(np.float32)
        self.optimizer = optimizer
        self.lr = learning_rate
        if optimizer == "adagrad":
            self._g2 = np.zeros_like(self.data)
        elif optimizer != "sgd":
            raise ValueError(f"unsupported sparse optimizer {optimizer!r}")

    def _local(self, ids):
        ids = np.asarray(ids).reshape(-1)
        if self.num_shards > 1:
            mine = (ids % self.num_shards) == self.shard_id
            if not mine.all():
                raise ValueError("ids routed to the wrong shard")
        return ids // self.num_shards

    def pull(self, ids):
        """Gather rows for `ids` -> [n, dim] float32 (host array; the
        caller ships it to device)."""
        return self.data[self._local(ids)]

    def push(self, ids, grads):
        """Apply sparse gradients (sum-merged over duplicate ids)."""
        li = self._local(ids)
        g = np.asarray(grads, np.float32).reshape(len(li), self.dim)
        if self.optimizer == "adagrad":
            np.add.at(self._g2, li, g * g)
            g = g / (np.sqrt(self._g2[li]) + 1e-6)
        np.add.at(self.data, li, -self.lr * g)

    def state_dict(self):
        d = {"data": self.data, "global_rows": self._global_rows}
        if self.optimizer == "adagrad":
            d["g2"] = self._g2
        return d

    def set_state_dict(self, d):
        self.data = np.asarray(d["data"], np.float32)
        if "g2" in d and self.optimizer == "adagrad":
            self._g2 = np.asarray(d["g2"], np.float32)


class PSEmbedding(nn.Module):
    """An embedding layer backed by a SparseTable (the reference's
    distributed lookup-table op pair: lookup, then send the sparse
    gradient)."""

    def __init__(self, num_embeddings, embedding_dim, table=None,
                 optimizer="sgd", learning_rate=0.1, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.table = table or SparseTable(num_embeddings, embedding_dim,
                                          optimizer=optimizer,
                                          learning_rate=learning_rate)
        self._pending = []

    def forward(self, ids):
        ids_np = ids.detach().cpu().numpy() if torch.is_tensor(ids) \
            else np.asarray(ids)
        flat = ids_np.reshape(-1)
        pulled = torch.from_numpy(self.table.pull(flat)).to(
            self.device).requires_grad_(True)
        self._pending.append((flat, pulled))
        return pulled.reshape(tuple(ids_np.shape) + (self.table.dim,))

    def apply_gradients(self):
        """Push the gradients of every pull since the last call."""
        for ids, pulled in self._pending:
            if pulled.grad is not None:
                self.table.push(ids, pulled.grad.detach().cpu().numpy())
        self._pending.clear()


# ----------------------------------------------------------- fleet PS roles

class _PSRuntime:
    """The process's table registry: the "server" of one host."""

    def __init__(self):
        self.tables = {}
        self.running = False

    def register_table(self, name, table):
        self.tables[name] = table
        return table


_runtime = _PSRuntime()


def runtime():
    return _runtime


def init_server(model_dir=None, **kwargs):
    _runtime.running = True
    if model_dir:
        import os
        import pickle
        path = os.path.join(model_dir, "sparse_tables.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                states = pickle.load(f)
            for name, st in states.items():
                if name in _runtime.tables:
                    _runtime.tables[name].set_state_dict(st)


def run_server():
    _runtime.running = True


def init_worker():
    pass


def stop_worker():
    _runtime.running = False


def save_persistables(dirname, **kwargs):
    import os
    import pickle
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "sparse_tables.pkl"), "wb") as f:
        pickle.dump({n: t.state_dict()
                     for n, t in _runtime.tables.items()}, f)


__all__ = ["SparseTable", "PSEmbedding", "runtime", "init_server",
           "run_server", "init_worker", "stop_worker", "save_persistables"]
