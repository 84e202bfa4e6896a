"""paddle.reader of the port — reader (generator) decorators, copied from
the reference's `paddle_tpu/reader/__init__.py` (Paddle's
python/paddle/reader/decorator.py:1-672). A "reader" is a zero-arg
callable returning an iterator over samples; decorators wrap readers
into new readers. These feed the host-side input pipeline (the device
pipeline is io.DataLoader); they are pure Python — the card never sees a
reader, only the batched arrays the pipeline emits.

Implemented (reference names + semantics):
  cache, map_readers, shuffle, chain, compose, buffered, firstn,
  xmap_readers, multiprocess_reader
"""
from __future__ import annotations

import itertools
import multiprocessing
import queue as _queue
import random
import threading

__all__ = [
    "cache", "map_readers", "buffered", "compose", "chain", "shuffle",
    "firstn", "xmap_readers", "multiprocess_reader", "batch",
]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (ref: python/paddle/batch.py
    — also exported as paddle.batch / fluid.io.batch)."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def cache(reader):
    """Cache the reader's full output in memory on the first pass (ref:
    decorator.py:51)."""
    all_data = tuple(reader())

    def cached_reader():
        return iter(all_data)

    return cached_reader


def map_readers(func, *readers):
    """Aligned map over several readers: yields func(*one_sample_each)
    (ref: decorator.py:91)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (ref: decorator.py:133): fill a buf_size window,
    shuffle it, emit; repeat."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers back to back (ref: decorator.py:182)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into combined samples, flattening tuple outputs (ref:
    decorator.py:247). check_alignment=True raises ComposeNotAligned when
    readers run out at different lengths."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(map(make_tuple, outputs), ())

    return reader


def buffered(reader, size):
    """Decouple producer/consumer with a `size`-deep queue fed by a
    background thread (ref: decorator.py:307)."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)

        def feed():
            try:
                for d in r:
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def firstn(reader, n):
    """First n samples (ref: decorator.py:366)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map with `process_num` worker threads over a buffered
    queue; order=True restores input order (ref: decorator.py:411 — the
    reference also uses threads here, not processes)."""

    end = object()

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
        else:
            pending = {}
            next_i = 0
            while finished < process_num or pending:
                if next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
                    continue
                if finished == process_num:
                    break
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                i, mapped = item
                pending[i] = mapped

    return xreader


def _mp_feed(reader_fn, q):
    try:
        for sample in reader_fn():
            q.put(sample)
    finally:
        q.put(None)


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run each reader in its OWN process, merging their outputs through a
    shared queue (ref: decorator.py:504). Order across readers is
    arbitrary, like the reference. `use_pipe` is accepted for API parity;
    both modes use a multiprocessing.Queue here (the reference's pipe mode
    exists to dodge a CPython queue bug this runtime doesn't have)."""
    assert len(readers) > 0, "readers should not be empty"

    def reader():
        ctx = multiprocessing.get_context("fork")
        q = ctx.Queue(queue_size)
        procs = [ctx.Process(target=_mp_feed, args=(r, q), daemon=True)
                 for r in readers]
        for p in procs:
            p.start()
        finished = 0
        try:
            while finished < len(readers):
                sample = q.get()
                if sample is None:
                    finished += 1
                    continue
                yield sample
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

    return reader
