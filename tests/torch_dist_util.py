"""Gloo CPU worlds for the twins of the port's parallel slice.

`run_world(fn, nprocs, tmp_path, *args)` starts `nprocs` processes (the
spawn start method), joins them into a gloo world through a `file://`
store under `tmp_path` (no port to race for between xdist workers),
calls `fn(rank, *args)` in each and returns {rank: result} with every
tensor in the result turned into numpy. A world has a hard timeout: when
it expires every rank is killed and the test fails (a rank that waits for
ever in a collective fails its test rather than hanging it). A rank that
raises fails the test with its traceback.

`fn` must be importable by the children (a module-level function of a
test module whose top level imports no JAX).
"""
import os
import pickle
import time
import traceback

WORLD_TIMEOUT = 240.0


def _to_numpy(x):
    import torch
    if torch.is_tensor(x):
        t = x.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x) if type(x) in (list, tuple) \
            else tuple(_to_numpy(v) for v in x)
    return x


def _rank_main(fn, rank, nprocs, store, out_dir, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        import datetime
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=nprocs,
            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT))
        res = _to_numpy(fn(rank, *args))
        with open(path + ".pkl", "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_world(fn, nprocs, tmp_path, *args, timeout=WORLD_TIMEOUT):
    import multiprocessing as mp
    out_dir = os.path.join(str(tmp_path), f"world{time.monotonic_ns()}")
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, store, out_dir, args))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    errs = []
    for r in range(nprocs):
        e = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(e):
            errs.append(f"rank {r}:\n" + open(e).read())
    if errs:
        raise AssertionError("\n".join(errs))
    if alive:
        raise AssertionError(f"world of {nprocs} timed out after {timeout} s;"
                             f" ranks {alive} killed")
    out = {}
    for r in range(nprocs):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return out

