"""CPU twins of the port's `paddle.io` (`paddle_tpu_torch.io`: datasets,
samplers, the DataLoader, its worker processes and the native byte
queue) against the reference's `paddle_tpu.io`: every case of
`test_io_checkpoint.py::TestData` and of `test_dataloader_workers.py`.

Index orders are compared bit for bit with the reference's under one
`np.random.seed` (both draw from numpy's global generator); batches are
compared exactly (the same numpy stacking on both sides) for
`num_workers` 0, 2 and a persistent pool. The reference's
`test_speedup_with_workers` asserts a wall-clock ratio; its twin counts
instead: the most `__getitem__` calls in flight at once across the
workers (>= 2 of 4 workers means they overlapped) and the worker
processes that produced items. Worker datasets are a few items.
"""
import multiprocessing
import os
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.io as rio

import paddle_tpu_torch as ptt
import paddle_tpu_torch.io as pio
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.io import native_loader

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def _np(b):
    if torch.is_tensor(b):
        return b.numpy()
    return np.asarray(b.numpy() if hasattr(b, "numpy") else b)


def _batches(loader):
    out = []
    for b in loader:
        fields = b if isinstance(b, (tuple, list)) else (b,)
        out.append([_np(f) for f in fields])
    return out


def _same(a, b):
    """Batches a (the port's) equal b exactly. The reference holds int64
    data as int32 (JAX without x64); the port keeps int64."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if v.dtype == np.int32 and u.dtype == np.int64:
                v = v.astype(np.int64)
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


class Range:
    """(x [1] float32, y [1] int64) of index i (the reference test's
    RangeDataset), for either package's Dataset base."""

    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.array([i], np.float32), np.array([i % 3], np.int64)

    def __len__(self):
        return self.n


class PRange(Range, pio.Dataset):
    pass


class RRange(Range, rio.Dataset):
    pass


# ---- TestData twins ----------------------------------------------------

def test_tensor_dataset_and_loader():
    xs = np.arange(10, dtype=np.float32).reshape(10, 1)
    ys = np.arange(10, dtype=np.int64)
    batches = list(pio.DataLoader(pio.TensorDataset([xs, ys]), batch_size=4))
    want = _batches(rio.DataLoader(rio.TensorDataset([xs, ys]),
                                   batch_size=4))
    assert len(batches) == 3
    assert list(batches[0][0].shape) == [4, 1]
    assert list(batches[2][0].shape) == [2, 1]
    _same(_batches(batches), want)


def test_shuffle_covers_all_in_the_reference_order():
    seen = {}
    for name, mod, ds in (("port", pio, PRange(20)), ("ref", rio,
                                                       RRange(20))):
        np.random.seed(11)
        loader = mod.DataLoader(ds, batch_size=5, shuffle=True)
        seen[name] = [int(v) for e in range(2) for x, _ in loader
                      for v in _np(x).reshape(-1)]
    assert sorted(seen["port"][:20]) == list(range(20))
    assert seen["port"] == seen["ref"]


def test_batch_sampler():
    bs = pio.BatchSampler(PRange(10), batch_size=3, drop_last=True)
    assert len(bs) == 3
    assert all(len(b) == 3 for b in bs)
    assert list(bs) == list(rio.BatchSampler(RRange(10), batch_size=3,
                                             drop_last=True))


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_shards(shuffle):
    def shards(mod, ds):
        out = []
        for r in range(4):
            s = mod.DistributedBatchSampler(ds, batch_size=2, num_replicas=4,
                                            rank=r, shuffle=shuffle)
            s.set_epoch(3)
            out.append(list(s))
        return out

    port = shards(pio, PRange(18))
    assert sorted(set(i for s in port for b in s for i in b)) == \
        list(range(18))
    assert port == shards(rio, RRange(18))


@pytest.mark.parametrize("kind", ["random", "replacement", "weighted",
                                  "split"])
def test_sampler_orders_match_reference(kind):
    def draw(mod, ds):
        np.random.seed(5)
        if kind == "random":
            return list(mod.RandomSampler(ds))
        if kind == "replacement":
            return list(mod.RandomSampler(ds, replacement=True,
                                          num_samples=30))
        if kind == "weighted":
            return list(mod.WeightedRandomSampler(
                np.linspace(0.1, 1.0, 12), 25))
        return [s.indices for s in mod.random_split(ds, [5, 7])]

    assert draw(pio, PRange(12)) == draw(rio, RRange(12))


def test_num_workers_prefetch():
    assert len(list(pio.DataLoader(PRange(12), batch_size=4,
                                   num_workers=2))) == 3


class Stream:
    def __iter__(self):
        for i in range(7):
            yield np.array([i], np.float32)


class PStream(Stream, pio.IterableDataset):
    pass


class RStream(Stream, rio.IterableDataset):
    pass


def test_iterable_dataset():
    batches = _batches(pio.DataLoader(PStream(), batch_size=3))
    assert len(batches) == 3
    _same(batches, _batches(rio.DataLoader(RStream(), batch_size=3)))
    assert len(_batches(pio.DataLoader(PStream(), batch_size=3,
                                       drop_last=True))) == 2


def test_compose_chain_concat_subset():
    a, b = PRange(5), PRange(3)
    assert len(pio.ConcatDataset([a, b])) == 8
    assert _np(pio.ConcatDataset([a, b])[6][0])[0] == 1.0
    assert pio.ComposeDataset([a, b])[2][2][0] == 2.0
    assert len(pio.ComposeDataset([a, b])) == 3
    assert [int(x[0]) for x in pio.ChainDataset([PStream(), PStream()])] \
        == list(range(7)) * 2
    assert _np(pio.Subset(a, [4, 0])[0][0])[0] == 4.0


# ---- worker processes --------------------------------------------------

@pytest.mark.parametrize("mode", ["in_process", "workers", "persistent"])
def test_worker_batches_equal_reference(mode):
    """Two shuffled epochs in each mode equal the reference's loader in
    the same mode (the worker base seed is one draw from numpy's global
    generator an epoch on both sides)."""
    kw = {"in_process": {}, "workers": {"num_workers": 2},
          "persistent": {"num_workers": 2, "persistent_workers": True}}[mode]
    got = {}
    for name, mod, ds in (("port", pio, PRange(24)),
                          ("ref", rio, RRange(24))):
        np.random.seed(3)
        loader = mod.DataLoader(ds, batch_size=5, shuffle=True, **kw)
        got[name] = _batches(loader) + _batches(loader)
        loader.close()
    _same(got["port"], got["ref"])


def test_first_epoch_equal_across_worker_counts():
    """Workers started per epoch draw their base seed after the epoch's
    indices, so the first epoch is the in-process loader's. (A
    persistent pool draws it first, as the reference's does.)"""
    got = []
    for kw in ({}, {"num_workers": 2}):
        np.random.seed(3)
        got.append(_batches(pio.DataLoader(PRange(24), batch_size=5,
                                           shuffle=True, **kw)))
    _same(got[0], got[1])


def test_batches_land_on_the_loader_device():
    (x, y), = list(pio.DataLoader(PRange(4), batch_size=4, places="cpu"))
    assert x.device.type == y.device.type == "cpu"
    assert (x.dtype, y.dtype) == (torch.float32, torch.int64)


def test_native_queue_is_built_and_used(recwarn):
    path = native_loader.build()
    assert os.path.relpath(path, os.path.dirname(pio.__file__)).startswith(
        os.path.join("..", "_build", "native"))
    assert native_loader.get_lib() is native_loader.get_lib()
    from paddle_tpu_torch.io.worker import _ByteChannel
    ch = _ByteChannel(4)
    assert ch._lib is not None  # the native queue, no Python fallback
    ch.close()
    ch.destroy()
    list(pio.DataLoader(PRange(8), batch_size=4, num_workers=2))
    assert not [w for w in recwarn if "fell back" in str(w.message)
                or "byte-queue" in str(w.message)]


def test_native_prefetcher_and_arena():
    src = [(np.full((3,), i, np.float32), torch.arange(i + 1))
           for i in range(6)]
    got = list(native_loader.NativePrefetcher(iter(src), depth=2))
    assert len(got) == 6
    for (a, b), (c, d) in zip(src, got):
        np.testing.assert_array_equal(a, c)
        assert torch.equal(b, d)
    arena = native_loader.HostArena(1 << 20)
    buf, ptr = arena.buffer(4096)
    buf[:] = 7
    assert arena.reserved_bytes >= 4096
    arena.free(ptr)


class Slow(pio.Dataset):
    """CPU-bound __getitem__ (a busy wait holds the GIL) that counts the
    calls in flight across processes."""

    def __init__(self, n, delay):
        ctx = multiprocessing.get_context("fork")
        self.n, self.delay = n, delay
        self.live = ctx.Value("i", 0)
        self.peak = ctx.Value("i", 0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.live.get_lock():
            self.live.value += 1
            with self.peak.get_lock():
                self.peak.value = max(self.peak.value, self.live.value)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.delay:
            pass
        with self.live.get_lock():
            self.live.value -= 1
        return np.array([i, os.getpid()], np.int64)


def test_order_and_values():
    ds = Slow(32, 0.0)
    flat = np.concatenate([_np(b)[:, 0] for b in
                           pio.DataLoader(ds, batch_size=4, num_workers=2)])
    np.testing.assert_array_equal(flat, np.arange(32))


def test_workers_overlap_counted():
    """The twin of test_speedup_with_workers, by counting: 4 workers over
    16 slow items have >= 2 items in flight at once, from >= 2
    processes, none of them this one."""
    ds = Slow(16, 0.05)
    rows = np.concatenate([_np(b) for b in
                           pio.DataLoader(ds, batch_size=2, num_workers=4)])
    np.testing.assert_array_equal(rows[:, 0], np.arange(16))
    pids = set(rows[:, 1].tolist())
    assert len(pids) >= 2 and os.getpid() not in pids
    assert ds.peak.value >= 2
    serial = Slow(4, 0.0)
    list(pio.DataLoader(serial, batch_size=2))
    assert serial.peak.value == 1


class Failing(pio.Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        if i == 11:
            raise ValueError("boom at index 11")
        return np.zeros((2,), np.float32)


def test_worker_error_propagates_with_traceback():
    with pytest.raises(RuntimeError) as ei:
        list(pio.DataLoader(Failing(), batch_size=4, num_workers=2))
    assert "boom at index 11" in str(ei.value)
    assert "ValueError" in str(ei.value)
    assert "Traceback" in str(ei.value)


class Hanging(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 4:  # the second batch stalls 3 s, past the 1 s timeout
            time.sleep(3)
        return np.zeros((2,), np.float32)


def test_timeout():
    loader = pio.DataLoader(Hanging(), batch_size=4, num_workers=2,
                            timeout=1)
    with pytest.raises(RuntimeError, match="timed out"):
        list(loader)


class Info(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return np.array([i, -1 if info is None else info.id,
                         -1 if info is None else info.num_workers,
                         int(torch.cuda.is_initialized()),
                         int(os.environ.get("PTT_TEST_WID", "-1"))],
                        np.int64)


def test_get_worker_info_and_init_fn_inside_worker():
    def init(worker_id):
        os.environ["PTT_TEST_WID"] = str(worker_id)

    rows = np.concatenate([_np(b) for b in pio.DataLoader(
        Info(), batch_size=2, num_workers=2, worker_init_fn=init)])
    assert set(rows[:, 1]) <= {0, 1}
    assert (rows[:, 2] == 2).all()
    assert (rows[:, 3] == 0).all()  # no worker starts CUDA
    np.testing.assert_array_equal(rows[:, 4], rows[:, 1])
    assert pio.get_worker_info() is None
    rows = np.concatenate([_np(b) for b in pio.DataLoader(Info(),
                                                          batch_size=4)])
    assert (rows[:, 1] == -1).all()


def test_worker_init_fn_failure_raises():
    """The reference's map-style feeder counts the failure as a batch and
    ends the epoch empty; the port raises it (ROADMAP §C 37)."""
    def init(worker_id):
        raise KeyError("no init")

    with pytest.raises(RuntimeError, match="no init"):
        list(pio.DataLoader(Info(), batch_size=4, num_workers=2,
                            worker_init_fn=init, timeout=30))


class Sharded(pio.IterableDataset):
    def __init__(self, n=32):
        self.n = n

    def __iter__(self):
        info = pio.get_worker_info()
        wid = 0 if info is None else info.id
        nw = 1 if info is None else info.num_workers
        for i in range(wid, self.n, nw):
            yield np.array([i], np.int64)


def test_iterable_dataset_sharding():
    seen = sorted(int(x) for b in pio.DataLoader(Sharded(32), batch_size=4,
                                                 num_workers=2)
                  for x in _np(b).ravel())
    assert seen == list(range(32))


def test_shared_memory_roundtrip_dict_batches():
    class D(pio.Dataset):  # a local class: the fork start method takes it
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return {"x": np.full((3,), i, np.float32), "y": int(i),
                    "t": torch.full((2,), float(i))}

    for shm in (True, False):
        out = list(pio.DataLoader(D(), batch_size=4, num_workers=2,
                                  use_shared_memory=shm))
        assert len(out) == 2
        np.testing.assert_allclose(_np(out[0]["x"])[:, 0], [0, 1, 2, 3])
        assert out[1]["y"].tolist() == [4, 5, 6, 7]
        assert out[1]["t"].dtype == torch.float32


class Const(pio.Dataset):
    def __init__(self, n, width=2):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((self.width,), i, np.float32)


def _values(dl):
    return sorted(float(_np(b)[i, 0]) for b in dl for i in range(b.shape[0]))


def test_persistent_map_pool_survives_epochs():
    dl = pio.DataLoader(Const(12), batch_size=4, num_workers=2,
                        persistent_workers=True, shuffle=False)
    seen = []
    for _epoch in range(3):
        assert _values(dl) == [float(i) for i in range(12)]
        seen.append(id(dl._pool))
        assert all(w.is_alive() for w in dl._pool._workers)
    assert len(set(seen)) == 1
    pids = [w.pid for w in dl._pool._workers]
    dl.close()
    assert dl._pool is None
    assert len(set(pids)) == 2


def test_persistent_iterable_pool_survives_epochs():
    class IS(pio.IterableDataset):
        def __iter__(self):
            info = pio.get_worker_info()
            wid = info.id if info else 0
            nw = info.num_workers if info else 1
            for i in range(wid, 8, nw):
                yield np.full((2,), i, np.float32)

    dl = pio.DataLoader(IS(), batch_size=2, num_workers=2,
                        persistent_workers=True)
    for _epoch in range(2):
        assert _values(dl) == [float(i) for i in range(8)]
        assert all(w.is_alive() for w in dl._pool._workers)
    dl.close()


@pytest.mark.parametrize("n,width", [(12, 2), (200, 64)],
                         ids=["abandoned", "abandoned_blocked_feeder"])
def test_abandoned_epoch_does_not_leak_into_next(n, width):
    """One batch, then the epoch is abandoned; the next epoch is whole.
    200 items in batches of 2 outnumber the channel's depth, so the
    feeder is still blocked pushing when the next epoch starts."""
    import signal

    def _alarm(signum, frame):
        raise TimeoutError("persistent-worker reset deadlocked")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(120)
    try:
        dl = pio.DataLoader(Const(n, width), batch_size=2 if n > 12 else 4,
                            num_workers=2, persistent_workers=True)
        for _ in dl:
            break
        assert _values(dl) == [float(i) for i in range(n)]
        dl.close()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_no_fallback_warning_in_the_worker_path():
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert len(list(pio.DataLoader(PRange(8), batch_size=4,
                                       num_workers=2))) == 2


@pytest.mark.parametrize("persistent", [False, True])
def test_a_native_queue_that_does_not_build_raises(monkeypatch, persistent):
    """No in-process fallback (the reference gives way to a thread): the
    loader raises the build's error and yields no batch."""
    def broken():
        raise RuntimeError("g++ failed to build native_runtime.cpp")

    monkeypatch.setattr(native_loader, "get_lib", broken)
    dl = pio.DataLoader(PRange(8), batch_size=4, num_workers=2,
                        persistent_workers=persistent)
    got = []
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        for b in dl:
            got.append(b)
    assert got == []


@pytest.mark.parametrize("persistent", [False, True])
def test_workers_that_do_not_start_raise(monkeypatch, persistent):
    from paddle_tpu_torch.io import worker

    class NoFork:
        def Queue(self):
            return multiprocessing.get_context("fork").Queue()

        def Process(self, *a, **k):
            raise OSError("fork refused")

    monkeypatch.setattr(worker, "_mp_context", NoFork)
    dl = pio.DataLoader(PRange(8), batch_size=4, num_workers=2,
                        persistent_workers=persistent)
    with pytest.raises(OSError, match="fork refused"):
        list(dl)
