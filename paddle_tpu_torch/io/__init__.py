"""paddle.io of the port: datasets, samplers and the DataLoader (the port
of `paddle_tpu/io/__init__.py`).

What the reference does, the port does with the same arithmetic:

  * the shuffles draw from numpy's global generator (`RandomSampler`,
    `random_split`, `WeightedRandomSampler`) or from
    `RandomState(epoch)` (`DistributedBatchSampler`), so one
    `np.random.seed` gives the reference's index order bit for bit;
  * `default_collate_fn` stacks samples with numpy (float64 becomes
    float32, the reference's tensor rule) into CPU tensors — it never
    touches a card, so it runs as it is inside a worker process;
  * `num_workers > 0` runs `__getitem__` + collate in worker processes
    (`io.worker`), batches crossing in shared memory through the native
    byte queue (`io.native_loader`, `csrc/native_runtime.cpp`, built by
    g++ at first use). A failure to start the workers or to build the
    native queue raises with its cause; there is no in-process fallback
    (the reference gives way to a background thread there).

Batches arrive as `torch.Tensor`s on the loader's device: `places`
when given, else `get_device()` at the start of each epoch — the card,
unless `set_device("cpu")`; it raises where there is no card. Only the
consumer's process moves a batch to the card: workers ship numpy.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..core.tensor import _as_tensor


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")


def _host(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = [_host(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    idx = np.random.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, idx[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(p), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


def _batches_of(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        return _batches_of(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the indices across data-parallel ranks: rank r takes every
    nranks-th index from r, the list padded by its head to a multiple
    of nranks; shuffled by `RandomState(epoch)` (`set_epoch`)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n) \
                .tolist()
        else:
            indices = list(range(n))
        indices += indices[:self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        return _batches_of(indices, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stack a list of samples (tuples, lists, dicts, tensors, arrays or
    numbers) field by field into CPU tensors."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return _as_tensor(np.stack([_host(b) for b in batch]))


def _to_device(batch, device):
    """`batch` with every tensor in it moved to `device` (numpy arrays
    and other values as they are)."""
    if torch.is_tensor(batch):
        return batch.to(device)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers and num_workers > 0
        self._pool = None  # the live worker pool when persistent
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _device(self):
        """The torch.device this epoch's batches land on (`places`, else
        `get_device()`; raises where that is a card and there is none)."""
        from ..device import resolve_device
        place = self.places
        if isinstance(place, (list, tuple)):
            place = place[0] if place else None
        return resolve_device(place)

    def close(self):
        """Release the persistent worker pool (no-op otherwise)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):  # pragma: no cover - gc path
        try:
            self.close()
        except Exception:
            pass

    def _iter_batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        dev = self._device()
        src = self._iter_batches() if self.num_workers <= 0 \
            else self._multiprocess_iter()
        for batch in src:
            yield _to_device(batch, dev)

    def _epoch_batches(self):
        return None if self._iterable_mode else list(self.batch_sampler)

    def _worker_iter(self, batches, persistent=False):
        from .worker import MultiprocessLoaderIter
        it = self._iterable_mode
        return MultiprocessLoaderIter(
            self.dataset, self.collate_fn, batches, self.num_workers,
            self.prefetch_factor, self.timeout, self.worker_init_fn,
            self.use_shared_memory,
            iterable_batch_size=self.batch_size if it else None,
            iterable_drop_last=self.drop_last if it else False,
            persistent=persistent)

    def _multiprocess_iter(self):
        """Worker processes run __getitem__ + collate (`io.worker`). A
        failure to start them raises: nothing gives way to an in-process
        producer."""
        if self.persistent_workers:
            if self._pool is None or self._pool._shutdown:
                self._pool = self._worker_iter(None, persistent=True)
            # the epoch's indices are drawn after the pool's base seed
            yield from self._pool.epoch(self._epoch_batches())
            return
        # here after: the workers' base seed is drawn after the indices
        yield from self._worker_iter(self._epoch_batches())


def get_worker_info():
    from .worker import get_worker_info as _gwi
    return _gwi()


class Transform:
    """Base dataset transform callable."""

    def __call__(self, data):
        return data


__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "default_collate_fn", "DataLoader",
           "get_worker_info", "Transform"]
