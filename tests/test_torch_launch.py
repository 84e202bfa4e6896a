"""CPU twins of the port's launcher (`python -m
paddle_tpu_torch.distributed.launch`) — the twin of
`test_multiprocess_launch.py`, whose two-process jax.distributed case the
reference skips on the CPU (its jaxlib has no multi-process CPU
collectives); the port's ranks join a gloo world.

Two ranks started by the launcher (`--nproc_per_node 2`, and one process
a rank with the reference's `--coordinator / --num_processes /
--process_id`) join through `init_parallel_env`, see their rank and
world, all-reduce rank + 1 (3 on both), and run the quantized
all-reduce on 4096 values a rank: within 2e-2 of the exact sum (the
reference test's bound) and within one int8 step (1/127 of the largest
magnitude) of the reference's `quantized_all_reduce` under shard_map on
two of the virtual devices. A rank that fails makes the launcher exit
with its code and terminate the other.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.collective import quantized_all_reduce
    from paddle_tpu_torch.parallel.mesh import make_mesh, mesh_guard

    torch.set_num_threads(1)
    env = dist.init_parallel_env(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert (env.rank, env.world_size) == (rank, world) == (
        int(os.environ["PADDLE_TRAINER_ID"]), 2)
    if sys.argv[2] == "fail":
        if rank == 1:
            raise SystemExit(7)
        import time
        time.sleep(120)   # the launcher must end this rank
        raise SystemExit(0)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    with mesh_guard(make_mesh(dp=world)):
        g = torch.from_numpy(np.random.RandomState(rank).randn(4096)
                             .astype(np.float32))
        q = quantized_all_reduce(g, "dp")
    np.save(os.path.join(sys.argv[1], f"q{rank}.npy"), q.numpy())
    with open(os.path.join(sys.argv[1], f"ok_{rank}.txt"), "w") as f:
        f.write(f"psum={t.item()}")
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _script(tmp_path):
    p = tmp_path / "worker.py"
    p.write_text(_WORKER)
    return str(p)


def _reference_qar():
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.collective import quantized_all_reduce
    g = np.stack([np.random.RandomState(r).randn(4096).astype(np.float32)
                  for r in range(2)])
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    out = jax.jit(shard_map(lambda x: quantized_all_reduce(x[0], "dp")[None],
                            mesh=mesh, in_specs=P("dp", None),
                            out_specs=P("dp", None), check_rep=False))(
        jnp.asarray(g))
    return np.asarray(out)[0], g.sum(0)


def _check(out_dir):
    ref, exact = _reference_qar()
    for r in range(2):
        with open(os.path.join(out_dir, f"ok_{r}.txt")) as f:
            assert f.read() == "psum=3.0"
        q = np.load(os.path.join(out_dir, f"q{r}.npy"))
        assert np.abs(q - exact).max() / np.abs(exact).max() < 2e-2
        assert np.abs(q - ref).max() <= np.abs(ref).max() / 127


@pytest.mark.parametrize("module", ["paddle_tpu_torch.distributed.launch",
                                    "paddle_tpu_torch.distributed.fleet."
                                    "launch"])
def test_launch_nproc_per_node(tmp_path, module):
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", module, "--nproc_per_node", "2",
         "--log_dir", str(logs), _script(tmp_path), str(tmp_path), "ok"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout, r.stderr,
                               [p.read_text() for p in logs.iterdir()])
    assert sorted(os.listdir(logs)) == ["workerlog.0", "workerlog.1"]
    _check(str(tmp_path))


def _coordinator_port():
    """A free port below the kernel's ephemeral range, where no outgoing
    connection of another process (the suite's other tests run beside
    this one) can take it between this check and rank 0's bind: the
    launcher's own rule."""
    from paddle_tpu_torch.distributed.utils import free_port
    return free_port()


def test_launch_one_process_a_rank_with_coordinator(tmp_path):
    """Each rank's output goes to a file (a pipe nobody reads until the
    end would block a chatty rank); a rendezvous whose port another
    process took in the meantime (rank 0's store fails with EADDRINUSE,
    and rank 1 would wait for it until the limit) is started again on a
    new port, within the same 240 s."""
    import time
    script = _script(tmp_path)
    deadline = time.monotonic() + 240
    for attempt in range(3):
        port = _coordinator_port()
        logs = [tmp_path / f"a{attempt}_rank{pid}.log" for pid in range(2)]
        procs = []
        for pid in range(2):
            with open(logs[pid], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "paddle_tpu_torch.distributed.launch",
                     f"--coordinator=127.0.0.1:{port}", "--num_processes=2",
                     f"--process_id={pid}", script, str(tmp_path), "ok"],
                    cwd=REPO, env=_env(), stdout=out,
                    stderr=subprocess.STDOUT, text=True))
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break  # a rank failed: its peer would wait forever
                if time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired(procs[0].args, 240)
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = [(p.returncode, log.read_text()) for p, log in
                zip(procs, logs)]
        if all(rc == 0 for rc, _ in outs):
            break
        if not any("EADDRINUSE" in text for _, text in outs):
            break
    assert all(rc == 0 for rc, _ in outs), outs
    _check(str(tmp_path))


def test_failing_rank_ends_the_job(tmp_path):
    import time
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", _script(tmp_path), str(tmp_path), "fail"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode == 7, (r.returncode, r.stderr[-2000:])
    assert time.monotonic() - t0 < 100  # rank 0 was terminated


def test_initialize_from_env_world_of_one(monkeypatch):
    from paddle_tpu_torch.distributed.launch import initialize_from_env
    monkeypatch.delenv("PADDLE_COORDINATOR", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    assert initialize_from_env(device="cpu") == (1, 0)


def _held_port():
    """A socket bound (not listening) to a port of the launcher's rule, as
    another process's socket can hold it: rank 0's store cannot bind it
    (EADDRINUSE), and a peer's connection to it is refused."""
    from paddle_tpu_torch.distributed.utils import free_port
    s = socket.socket()
    s.bind(("127.0.0.1", free_port()))
    return s


def test_launch_restarts_rendezvous_on_eaddrinuse(tmp_path, monkeypatch,
                                                  capfd):
    """The launcher's first port is taken before rank 0's store binds it
    (another socket holds it): rank 0 fails with EADDRINUSE, the launcher
    ends both ranks and starts them again on a new port, and the job
    ends 0 with the same results."""
    import importlib
    from paddle_tpu_torch.distributed import utils
    launch = importlib.import_module("paddle_tpu_torch.distributed.launch")
    held = _held_port()
    first = held.getsockname()[1]
    ports = iter([first])
    monkeypatch.setattr(launch, "free_port",
                        lambda host="127.0.0.1": next(ports, None)
                        or utils.free_port(host))
    monkeypatch.setenv("PYTHONPATH", _env()["PYTHONPATH"])
    monkeypatch.chdir(REPO)
    logs = tmp_path / "logs"
    try:
        with pytest.raises(SystemExit) as e:
            launch.main(["--nproc_per_node", "2", "--log_dir", str(logs),
                         _script(tmp_path), str(tmp_path), "ok"])
    finally:
        held.close()
    err = capfd.readouterr().err
    assert e.value.code == 0, (err, [p.read_text() for p in
                                     logs.iterdir()])
    assert f"rendezvous port {first} was taken" in err
    _check(str(tmp_path))


def _spawned_allreduce(out_dir):
    import torch
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(device="cpu")
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"s{dist.get_rank()}"), "w") as f:
        f.write(f"{os.environ['MASTER_PORT']} {t.item()}")


def test_spawn_restarts_rendezvous_on_eaddrinuse(tmp_path, monkeypatch):
    """spawn's first port is taken: rank 0's store fails with EADDRINUSE,
    the other rank (whose connections are refused) is ended, and the
    ranks start again on a new port within the same timeout."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import utils
    held = _held_port()
    first = held.getsockname()[1]
    ports = iter([first])
    real = utils.free_port
    monkeypatch.setattr(utils, "free_port",
                        lambda host="127.0.0.1": next(ports, None)
                        or real(host))
    try:
        dist.spawn(_spawned_allreduce, args=(str(tmp_path),), nprocs=2,
                   timeout=120)
    finally:
        held.close()
    got = [(tmp_path / f"s{r}").read_text().split() for r in range(2)]
    assert got[0] == got[1] and got[0][1] == "3.0"
    assert int(got[0][0]) != first
