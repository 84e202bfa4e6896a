"""fluid.reader module path (ref: fluid/reader.py — PyReader/DataLoader;
the port of `paddle_tpu/fluid/reader.py`).

PyReader was the 1.x way to pump python-generated
batches into the static Executor. Here it is a thin adapter that turns
the decorated generator into feed dicts keyed by the feed_list
Variables' names — exactly what `Executor.run(feed=...)` consumes — so
1.x training loops port without restructuring:

    reader = fluid.io.PyReader(feed_list=[x, y], capacity=64)
    reader.decorate_batch_generator(gen)
    for data in reader():
        exe.run(main_prog, feed=data, fetch_list=[loss])

The 2.0 path (io.DataLoader) is re-exported alongside, like the
reference does.
"""
from __future__ import annotations

import numpy as np

from ..io import DataLoader  # noqa: F401


class PyReader:
    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False):
        # capacity/use_double_buffer are accepted for signature parity:
        # prefetch depth is the consuming DataLoader/executor's concern
        self._feed_list = list(feed_list or [])
        self._iterable = iterable
        self._return_list = return_list
        self._batch_fn = None

    # -- decoration (ref: reader.py decorate_* trio) -----------------------
    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        """sample_generator yields ONE sample tuple at a time."""

        def batches():
            buf = []
            for sample in sample_generator():
                buf.append(sample if isinstance(sample, (tuple, list))
                           else (sample,))
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if buf and not drop_last:
                yield buf
        self._batch_fn = lambda: (self._stack(b) for b in batches())

    def decorate_sample_list_generator(self, reader, places=None):
        """reader yields a LIST of sample tuples per batch."""
        self._batch_fn = lambda: (self._stack(b) for b in reader())

    def decorate_batch_generator(self, reader, places=None):
        """reader yields already-batched arrays (tuple/list per feed)."""

        def norm():
            for batch in reader():
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                yield [np.asarray(a) for a in batch]
        self._batch_fn = norm

    # -- consumption -------------------------------------------------------
    def _stack(self, sample_list):
        n = len(sample_list[0])
        return [np.stack([np.asarray(s[i]) for s in sample_list])
                for i in range(n)]

    def _to_feed(self, arrays):
        if self._return_list or not self._feed_list:
            return list(arrays)
        names = [getattr(v, "name", str(i))
                 for i, v in enumerate(self._feed_list)]
        return dict(zip(names, arrays))

    def __call__(self):
        return iter(self)

    def __iter__(self):
        if self._batch_fn is None:
            raise RuntimeError(
                "PyReader has no source: call decorate_sample_generator / "
                "decorate_sample_list_generator / decorate_batch_generator "
                "first")
        for arrays in self._batch_fn():
            yield self._to_feed(arrays)

    # non-iterable 1.x mode ran the reader through exe.run() implicitly;
    # on this stack the executor consumes explicit feeds, so the iterable
    # protocol is the supported path (reference 2.0 defaults to it too)
    def start(self):
        if self._iterable:
            raise RuntimeError("start() is for iterable=False; this "
                               "PyReader is iterable — loop `for data in "
                               "reader():` and pass data as feed")
        raise NotImplementedError(
            "non-iterable PyReader (implicit executor feed) is not "
            "supported on this stack: construct with iterable=True and "
            "pass the yielded feed dicts to Executor.run explicitly")

    def reset(self):
        self.start()


__all__ = ["PyReader", "DataLoader"]
