"""DataLoader worker processes (the port of `paddle_tpu/io/worker.py`).

Workers run `__getitem__` + collate in their own processes, serialize
each batch into ONE buffer in POSIX shared memory, and a feeder thread
of the consumer's process copies each buffer into the native bounded
byte queue (`csrc/native_runtime.cpp`) with the GIL released — so batch
production, staging and consumption overlap. Order is restored by batch
index in the feeder; a worker's exception travels as its traceback text
and is raised again at the consumer (a failing `worker_init_fn` too,
at once: its worker takes no batch). `timeout`, `worker_init_fn`,
`get_worker_info`, iterable sharding (each worker iterates its own copy
and shards itself through `get_worker_info()`) and the persistent pool
are the reference's.

Workers are forked. The consumer may already have started CUDA; a worker touches no card: it
builds numpy arrays and CPU tensors only (`default_collate_fn` never
touches a card), runs torch on one thread, and ships numpy. Only the
consumer turns a batch into tensors on its device.
"""
from __future__ import annotations

import itertools
import pickle
import queue as pyqueue
import threading
import traceback
from dataclasses import dataclass

import numpy as np

_TAG_BATCH = b"B"
_TAG_ERR = b"E"
_TAG_END = b"X"


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: int
    dataset: object = None


_worker_info = None


def get_worker_info():
    """Inside a worker process: this worker's (id, num_workers, seed,
    dataset). In the main process: None. (ref: dataloader_iter.py)"""
    return _worker_info


def _seed_worker(worker_id, base_seed):
    import random
    random.seed(base_seed + worker_id)
    np.random.seed((base_seed + worker_id) % (2 ** 31))


def _worker_loop(dataset, collate_fn, index_queue, result_queue, worker_id,
                 num_workers, base_seed, worker_init_fn, use_shared_memory,
                 iterable_batch_size, iterable_drop_last, persistent=False):
    """Target of each worker process. Map-style: pops (batch_idx, indices)
    tasks. Iterable-style: iterates its own dataset copy (the dataset uses
    get_worker_info() to shard itself) and emits (-1, batch) results.

    persistent: map-style needs no change (the parent simply withholds the
    None sentinel until loader shutdown); iterable-style waits for an
    epoch token per epoch instead of exiting after one pass."""
    global _worker_info
    import torch
    torch.set_num_threads(1)  # the consumer's thread pool is not forked
    _worker_info = WorkerInfo(id=worker_id, num_workers=num_workers,
                              seed=base_seed + worker_id, dataset=dataset)
    _seed_worker(worker_id, base_seed)
    if worker_init_fn is not None:
        try:
            worker_init_fn(worker_id)
        except Exception:
            result_queue.put(("err", -1, traceback.format_exc()))
            return

    def emit(batch_idx, batch):
        from .native_loader import _serialize_batch
        data = _serialize_batch(batch)
        if use_shared_memory:
            from multiprocessing import shared_memory
            shm = shared_memory.SharedMemory(create=True, size=len(data))
            shm.buf[:len(data)] = data
            # the consumer owns the segment from here (it attaches and
            # unlinks it): the create's registration would be a leak
            # report at exit
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
            result_queue.put(("shm", batch_idx, shm.name, len(data)))
            shm.close()  # parent attaches + unlinks
        else:
            result_queue.put(("data", batch_idx, data))

    try:
        if iterable_batch_size is not None:  # iterable mode
            while True:
                if persistent:
                    tok = index_queue.get()
                    if tok is None:  # shutdown
                        return
                it = iter(dataset)
                while True:
                    batch = list(itertools.islice(it, iterable_batch_size))
                    if not batch or (len(batch) < iterable_batch_size
                                     and iterable_drop_last):
                        break
                    emit(-1, collate_fn(batch))
                result_queue.put(("done", worker_id, None))
                if not persistent:
                    return
        while True:
            task = index_queue.get()
            if task is None:
                break
            batch_idx, indices = task
            try:
                emit(batch_idx, collate_fn([dataset[i] for i in indices]))
            except Exception:
                result_queue.put(("err", batch_idx, traceback.format_exc()))
    except (KeyboardInterrupt, EOFError):
        pass


class _ByteChannel:
    """Parent-side staging channel: the C++ bounded byte queue. Frames are
    tag + payload. A native library that does not build raises here."""

    def __init__(self, depth, capacity_mb=1024):
        import ctypes

        from .native_loader import get_lib
        self._ctypes = ctypes
        self._lib = get_lib()
        self._q = self._lib.ptq_create(depth, capacity_mb << 20)

    def push(self, tag, payload):
        buf = (self._ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        self._lib.ptq_push_tagged(self._q, tag[0], buf, len(payload))

    def push_shm_frame(self, tag, shm_buf, nbytes):
        """Copy straight out of shared memory into the C++ queue — the
        memcpy runs inside ptq_push_tagged with the GIL released."""
        buf = (self._ctypes.c_uint8 * nbytes).from_buffer(shm_buf)
        self._lib.ptq_push_tagged(self._q, tag[0], buf, nbytes)

    def pop(self, timeout=None):
        """Returns (tag, payload_memoryview) or None on timeout."""
        ms = int((timeout or 3600) * 1000)
        out_cap = 1 << 16
        while True:
            out = (self._ctypes.c_uint8 * out_cap)()
            r = self._lib.ptq_pop_timed(self._q, out, out_cap, ms)
            if r == -3:
                return None
            if r == -1:
                return _TAG_END, memoryview(b"")
            if r == -2:
                n = self._lib.ptq_peek_size(self._q)
                if n < 0:
                    return _TAG_END, memoryview(b"")
                out_cap = int(n)
                continue
            data = memoryview(out)[:int(r)]
            return bytes(data[:1]), data[1:]

    def close(self):
        self._lib.ptq_close(self._q)

    def destroy(self):
        self._lib.ptq_destroy(self._q)


def _mp_context():
    """Fork: fast, and the consumer's CUDA state is never touched in a
    worker (it ships numpy)."""
    import multiprocessing as mp
    return mp.get_context("fork")


class MultiprocessLoaderIter:
    """One epoch's iterator over worker processes (map or iterable style)."""

    def __init__(self, dataset, collate_fn, batches, num_workers,
                 prefetch_factor=2, timeout=0, worker_init_fn=None,
                 use_shared_memory=True, iterable_batch_size=None,
                 iterable_drop_last=False, base_seed=None, persistent=False):
        ctx = _mp_context()
        self.timeout = timeout or None
        self.num_workers = num_workers
        self._iterable = iterable_batch_size is not None
        self._batches = list(batches) if batches is not None else None
        self._persistent = persistent
        self._result_queue = ctx.Queue()
        self._index_queue = ctx.Queue() if not self._iterable else None
        # iterable+persistent: epoch tokens must be PER-WORKER queues — in
        # a shared queue a fast worker pops both tokens, runs its shard
        # twice and the feeder's done-count closes the epoch while the
        # starved worker's shard never arrives (flaky dup/drop)
        self._index_queues = [ctx.Queue() for _ in range(num_workers)] \
            if (self._iterable and persistent) else None
        depth = max(2, num_workers * prefetch_factor)
        self._chan = _ByteChannel(depth)
        self._shutdown = False
        base_seed = np.random.randint(1 << 30) if base_seed is None \
            else base_seed

        self._workers = []
        for wid in range(num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(dataset, collate_fn,
                      self._index_queues[wid] if self._index_queues
                      else self._index_queue,
                      self._result_queue, wid, num_workers, base_seed,
                      worker_init_fn, use_shared_memory,
                      iterable_batch_size, iterable_drop_last, persistent),
                daemon=True)
            w.start()
            self._workers.append(w)

        if persistent:
            return  # epochs armed explicitly via reset()/epoch()
        if not self._iterable:
            self._n_batches = len(self._batches)
            for task in enumerate(self._batches):
                self._index_queue.put(task)
            for _ in range(num_workers):
                self._index_queue.put(None)
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    # -- persistent-workers protocol (ref: persistent_workers=True) -------
    def reset(self, batches=None):
        """Arm one epoch on the live worker pool: push the epoch's tasks
        (map) or one epoch token per worker (iterable) and start a fresh
        feeder. Workers stay alive across epochs; worker_init_fn ran once
        at spawn (reference persistent_workers semantics)."""
        assert self._persistent and not self._shutdown
        # a previous epoch abandoned mid-iteration (consumer broke out of
        # epoch()) leaves its feeder running and frames in the channel —
        # let the workers drain the already-queued tasks, then discard the
        # stale frames, or they would leak into this epoch's stream
        feeder = getattr(self, "_feeder", None)
        if feeder is not None and feeder.is_alive():
            # the feeder may be BLOCKED pushing into the full bounded
            # channel — joining first would deadlock. Drain concurrently
            # until it exits (every pop frees a slot for its next push; the
            # workers finish the old epoch's queued tasks, so the feeder's
            # receive loop terminates), then discard whatever is left.
            # Drain until the feeder exits. The stall guard is PROGRESS
            # based, not iteration based: as long as frames keep arriving
            # the workers are healthy (however slow), matching the
            # loader's own timeout semantics (self.timeout, None = wait
            # forever → a generous stall default applies only here).
            import time as _time
            stall_limit = self.timeout or 300.0
            last_progress = _time.time()
            while feeder.is_alive():
                # tight drain: pop until the channel is momentarily empty.
                # Stop on an END frame too: a CLOSED channel's pop returns
                # END forever, never None.
                got = self._chan.pop(timeout=0.02)
                while got is not None and got[0] != _TAG_END:
                    last_progress = _time.time()
                    got = self._chan.pop(timeout=0.02)
                feeder.join(timeout=0.05)
                if _time.time() - last_progress > stall_limit:
                    break
            if feeder.is_alive():
                self._shutdown_workers()
                raise RuntimeError(
                    "persistent DataLoader could not finish the abandoned "
                    "previous epoch (worker dead or stalled)")
        if getattr(self, "_epoch_open", False):
            while True:
                got = self._chan.pop(timeout=0.05)
                if got is None or got[0] == _TAG_END:
                    break
        self._epoch_open = True
        if self._iterable:
            for q in self._index_queues:
                q.put(True)  # exactly one epoch token per worker
        else:
            self._batches = list(batches)
            self._n_batches = len(self._batches)
            for task in enumerate(self._batches):
                self._index_queue.put(task)
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def epoch(self, batches=None):
        """One epoch's batch stream off the persistent pool; the pool
        survives the END marker (shutdown only on error or close())."""
        from .native_loader import _deserialize_batch
        self.reset(batches)
        while True:
            got = self._chan.pop(timeout=self.timeout)
            if got is None:
                self._shutdown_workers()
                raise RuntimeError(
                    f"DataLoader timed out after {self.timeout}s")
            tag, payload = got
            if tag == _TAG_END:
                self._epoch_open = False
                return
            if tag == _TAG_ERR:
                self._shutdown_workers()
                raise RuntimeError("DataLoader worker failed:\n"
                                   + pickle.loads(bytes(payload)))
            yield _deserialize_batch(payload)

    def close(self):
        """Persistent-pool shutdown: release the workers via sentinels."""
        if self._shutdown:
            return
        if self._index_queues is not None:
            for q in self._index_queues:
                q.put(None)
        else:
            for _ in range(self.num_workers):
                self._index_queue.put(None)
        self._shutdown_workers()

    # -- feeder thread: result_queue -> (reorder) -> byte channel ---------
    def _feed(self):
        try:
            if self._iterable:
                done = 0
                while done < self.num_workers:
                    msg = self._get_result()
                    if msg is None:
                        return  # timeout error already pushed
                    kind, idx, a, b = msg
                    if kind == "done":
                        done += 1
                        continue
                    self._push_result(kind, a, b)
                self._chan.push(_TAG_END, b"")
                return
            received = 0
            reorder = {}
            next_out = 0
            while received < self._n_batches:
                msg = self._get_result()
                if msg is None:
                    return
                kind, idx, a, b = msg
                if idx < 0:  # a worker_init_fn failed: no batch follows
                    self._push_result(kind, a, b)
                    return
                received += 1
                reorder[idx] = (kind, a, b)
                while next_out in reorder:
                    self._push_result(*reorder.pop(next_out))
                    next_out += 1
            self._chan.push(_TAG_END, b"")
        except Exception:
            try:
                self._chan.push(_TAG_ERR, pickle.dumps(
                    traceback.format_exc()))
            except Exception:
                pass
        finally:
            if not self._persistent:
                self._chan.close()

    def _get_result(self):
        try:
            msg = self._result_queue.get(timeout=self.timeout)
        except pyqueue.Empty:
            self._chan.push(_TAG_ERR, pickle.dumps(
                f"DataLoader timed out after {self.timeout}s waiting for a "
                f"worker batch ({sum(w.is_alive() for w in self._workers)}"
                f"/{self.num_workers} workers alive)"))
            self._chan.close()
            return None
        if len(msg) == 3:
            msg = (*msg, None)
        return msg

    def _push_result(self, kind, a, b):
        if kind == "err":
            self._chan.push(_TAG_ERR, pickle.dumps(a))
        elif kind == "shm":
            from multiprocessing import shared_memory
            shm = shared_memory.SharedMemory(name=a)
            try:
                self._chan.push_shm_frame(_TAG_BATCH, shm.buf, b)
            finally:
                shm.close()
                shm.unlink()
        else:  # inline bytes
            self._chan.push(_TAG_BATCH, a)

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        from .native_loader import _deserialize_batch
        if self._shutdown:
            raise StopIteration
        got = self._chan.pop(timeout=self.timeout)
        if got is None:
            self._shutdown_workers()
            raise RuntimeError(
                f"DataLoader timed out after {self.timeout}s")
        tag, payload = got
        if tag == _TAG_END:
            self._shutdown_workers()
            raise StopIteration
        if tag == _TAG_ERR:
            self._shutdown_workers()
            raise RuntimeError(
                "DataLoader worker failed:\n" + pickle.loads(bytes(payload)))
        return _deserialize_batch(payload)

    def _shutdown_workers(self):
        if self._shutdown:
            return
        self._shutdown = True
        # close first: a feeder blocked in the native queue's push wakes
        # with -1 (closed) instead of being destroyed under mid-wait, and
        # consumer pops see END. Then join the feeder, join/terminate the
        # workers, and unlink any shm segments still parked in the result
        # queue — TWICE, because a worker mid-emit can enqueue after the
        # first drain (abandoned-epoch shutdown would leak them).
        self._chan.close()
        feeder = getattr(self, "_feeder", None)
        if feeder is not None and feeder.is_alive():
            # push now returns "closed" and the feeder exits on its own
            feeder.join(timeout=10)

        def _drain_shm():
            while True:
                try:
                    msg = self._result_queue.get_nowait()
                except pyqueue.Empty:
                    break
                except Exception:  # pragma: no cover - closed queue
                    break
                if msg and msg[0] == "shm":
                    from multiprocessing import shared_memory
                    try:
                        shm = shared_memory.SharedMemory(name=msg[2])
                        shm.close()
                        shm.unlink()
                    except Exception:
                        pass

        _drain_shm()
        for w in self._workers:
            w.join(timeout=5)
        for w in self._workers:
            if w.is_alive():  # pragma: no cover - stuck worker
                w.terminate()
        _drain_shm()
        if feeder is None or not feeder.is_alive():
            self._chan.destroy()
        # else: deliberately LEAK the (closed, near-empty) queue — freeing
        # it under a wedged daemon feeder would be a use-after-free; the
        # allocation is a few KB and the thread dies with the process

    def __del__(self):  # pragma: no cover - gc path
        try:
            self._shutdown_workers()
        except Exception:
            pass
