"""paddle_tpu_torch.distributed — collectives, DataParallel, spawn and
launch, the sharded checkpoint, the fleet (strategy, meta-optimizers),
the parameter server's tables and the file datasets.

The port of `paddle_tpu/distributed/`. One process per rank over
torch.distributed: `spawn` (or `python -m
paddle_tpu_torch.distributed.launch`) starts the ranks (each sees
PADDLE_TRAINER_ID and the rendezvous in its environment) and
`init_parallel_env` joins them.
"""
from __future__ import annotations

import os

from .collective import (  # noqa: F401
    Group, ParallelEnv, ReduceOp, all_gather, all_reduce, alltoall, barrier,
    broadcast, get_group, get_rank, get_world_size, init_parallel_env,
    is_initialized, new_group, rank_device, reduce, reduce_scatter,
    resolve_backend, scatter, split, wait,
)
from .parallel import DataParallel  # noqa: F401
from .dataset import InMemoryDataset, QueueDataset  # noqa: F401
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401
from . import ps  # noqa: F401


class MultiprocessContext:
    """Join handle for spawned workers: join() waits for all and re-raises
    the first worker failure with its traceback, terminating the workers
    still running (a rank waiting on a failed peer would wait forever).
    With a timeout, workers still running when it expires are terminated
    and join raises TimeoutError (the reference's join returns with them
    running)."""

    def __init__(self, processes, error_queues):
        self.processes = processes
        self.error_queues = error_queues

    def join(self, timeout=None):
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        procs = self.processes
        while True:
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            if not alive or any(p.exitcode not in (0, None) for p in procs):
                break  # done, or a failed rank its peers may wait on
            if deadline is not None and time.monotonic() > deadline:
                self._kill()
                raise TimeoutError(f"spawned workers {alive} still "
                                   f"running after {timeout} s; "
                                   f"terminated")
            procs[alive[0]].join(0.1)
        failures = []
        for rank, (p, q) in enumerate(zip(procs, self.error_queues)):
            if p.exitcode not in (0, None):
                tb = q.get() if not q.empty() else "<no traceback captured>"
                failures.append((rank, p.exitcode, tb))
        self._kill()
        if failures:
            rank, code, tb = failures[0]
            raise RuntimeError(
                f"spawned worker {rank} exited with code {code}:\n{tb}")
        return True

    def _kill(self):
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join(5)


def _spawn_worker(func, args, rank, nprocs, error_queue, env):
    import sys
    import traceback
    os.environ.update(env)
    os.environ.update(PADDLE_TRAINER_ID=str(rank), RANK=str(rank),
                      LOCAL_RANK=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs),
                      WORLD_SIZE=str(nprocs),
                      LOCAL_WORLD_SIZE=str(nprocs))
    try:
        func(*args)
    except KeyboardInterrupt:
        pass
    except Exception:  # noqa: BLE001
        error_queue.put(traceback.format_exc())
        sys.exit(1)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start one process per rank running `func(*args)` (the reference's
    `spawn`, over torch.multiprocessing's spawn context). nprocs=-1 is the
    number of cards (at least 1). Each rank sees PADDLE_TRAINER_ID /
    RANK / LOCAL_RANK, PADDLE_TRAINERS_NUM / WORLD_SIZE and a rendezvous
    (MASTER_ADDR, MASTER_PORT: `port=` or a free port of
    `utils.free_port`), so `init_parallel_env()` joins them. With
    join=True, a port it chose itself that rank 0's store found taken
    (EADDRINUSE in the failure) makes it start the ranks again on a new
    port, at most `RENDEZVOUS_ATTEMPTS` times, within `timeout=`."""
    import time

    import torch
    import torch.multiprocessing as mp

    from .launch import RENDEZVOUS_ATTEMPTS
    from .utils import free_port, is_addr_in_use

    if nprocs <= 0:
        nprocs = max(1, torch.cuda.device_count())
    port = options.pop("port", None)
    timeout = options.pop("timeout", None)
    deadline = None if timeout is None else time.monotonic() + timeout
    ctx = mp.get_context("spawn")
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        env = {"MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port or free_port())}
        procs, queues = [], []
        for rank in range(nprocs):
            q = ctx.SimpleQueue()
            p = ctx.Process(target=_spawn_worker,
                            args=(func, args, rank, nprocs, q, env),
                            daemon=daemon)
            p.start()
            procs.append(p)
            queues.append(q)
        context = MultiprocessContext(procs, queues)
        if not join:
            return context
        try:
            context.join(None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
        except RuntimeError as e:
            if port is not None or not is_addr_in_use(str(e)) \
                    or attempt == RENDEZVOUS_ATTEMPTS - 1:
                raise
            continue
        return context


def launch():
    from . import launch as launch_mod
    launch_mod.main()


def prepare_context(strategy=None):
    """The 1.x dygraph bootstrap: `init_parallel_env`."""
    return init_parallel_env()


__all__ = ["Group", "ParallelEnv", "ReduceOp", "all_gather", "all_reduce",
           "alltoall", "barrier", "broadcast", "get_group", "get_rank",
           "get_world_size", "init_parallel_env", "is_initialized",
           "new_group", "rank_device", "reduce", "reduce_scatter",
           "resolve_backend", "scatter", "split", "wait", "DataParallel",
           "checkpoint", "spawn", "launch", "prepare_context",
           "MultiprocessContext", "InMemoryDataset", "QueueDataset", "fleet",
           "ps"]
