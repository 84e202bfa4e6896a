"""`python -m paddle_tpu_torch.distributed.launch`: start the ranks of a
job (the port of `paddle_tpu/distributed/launch.py`).

Two ways, as the reference's launcher and torch's:

  * `--nproc_per_node N script.py args...` starts N processes of the
    script on this host, each with its rank in the environment
    (PADDLE_TRAINER_ID / RANK / LOCAL_RANK, PADDLE_TRAINERS_NUM /
    WORLD_SIZE / LOCAL_WORLD_SIZE) and the rendezvous (MASTER_ADDR,
    MASTER_PORT: `--master_addr`, `--master_port`, or a free localhost
    port), so the script's `init_parallel_env()` joins them. It waits for
    all of them; when one fails the others are terminated and the
    launcher exits with the failing code. `--log_dir` writes each rank's
    output to workerlog.<rank> there.
  * `--coordinator HOST:PORT --num_processes N --process_id I script.py`
    (one process a host, the reference's arguments): the environment is
    set for rank I of N (the rendezvous at HOST:PORT) and the script runs
    in this process; its `init_parallel_env()` (or
    `initialize_from_env()`) joins the world.

Without either, the script runs here as the world of one.
"""
from __future__ import annotations

import argparse
import os
import runpy
import subprocess
import sys
import threading
import time

from .utils import free_port, is_addr_in_use, terminate_local_procs

RENDEZVOUS_ATTEMPTS = 3


def initialize_from_env(device=None):
    """Join the world named by PADDLE_COORDINATOR (or COORDINATOR_ADDRESS),
    PADDLE_TRAINERS_NUM and PADDLE_TRAINER_ID when it has more than one
    process; returns (world size, rank). `device` as `init_parallel_env`'s
    (None: this rank's card)."""
    coord = (os.environ.get("PADDLE_COORDINATOR")
             or os.environ.get("COORDINATOR_ADDRESS"))
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM",
                               os.environ.get("NUM_PROCESSES", "1")))
    pid = int(os.environ.get("PADDLE_TRAINER_ID",
                             os.environ.get("PROCESS_ID", "0")))
    if coord and nproc > 1:
        from .collective import init_parallel_env
        init_parallel_env(init_method=f"tcp://{coord}", rank=pid,
                          world_size=nproc, device=device)
    return nproc, pid


def _rank_env(rank, local_rank, world, local_world, addr, port):
    env = dict(os.environ)
    env.update(PADDLE_TRAINER_ID=str(rank), RANK=str(rank),
               LOCAL_RANK=str(local_rank), PADDLE_TRAINERS_NUM=str(world),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(local_world),
               MASTER_ADDR=addr, MASTER_PORT=str(port))
    return env


def _tee(stream, log, seen):
    """Copy rank 0's error output line by line to its log (else the
    launcher's stderr, fd 2), noting whether its store reported its port
    taken."""
    for line in iter(stream.readline, b""):
        if is_addr_in_use(line.decode("utf-8", "replace")):
            seen.set()
        if log is None:
            os.write(2, line)
        else:
            log.write(line)
            log.flush()
    stream.close()


def start_local_ranks(script, script_args, nproc, nnodes=1, node_rank=0,
                      master_addr="127.0.0.1", master_port=None,
                      log_dir=None):
    """Start this node's `nproc` ranks of `script`; returns the Popen
    handles (their log files, if any, on `.log`; on each, `.port` and
    `.addr_in_use`, an Event set when the rank's error output reported
    EADDRINUSE — watched on rank 0, whose store binds the port)."""
    port = master_port or free_port(master_addr)
    world = nnodes * nproc
    procs = []
    for local in range(nproc):
        rank = node_rank * nproc + local
        log = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            log = open(os.path.join(log_dir, f"workerlog.{rank}"), "wb")
        watched = rank == 0
        p = subprocess.Popen(
            [sys.executable, "-u", script] + list(script_args),
            env=_rank_env(rank, local, world, nproc, master_addr, port),
            stdout=log,
            stderr=(subprocess.PIPE if watched else
                    subprocess.STDOUT if log else None))
        p.log, p.port, p.addr_in_use, p.tee = log, port, threading.Event(), \
            None
        if watched:
            p.tee = threading.Thread(target=_tee, daemon=True,
                                     args=(p.stderr, log, p.addr_in_use))
            p.tee.start()
        procs.append(p)
    return procs


def watch(procs, poll=0.1):
    """Wait for every rank; when one fails, terminate the rest. Returns
    the first failing exit code, else 0."""
    code = 0
    try:
        while True:
            done = [p.poll() for p in procs]
            bad = [c for c in done if c not in (None, 0)]
            if bad:
                code = bad[0]
                terminate_local_procs(procs)
                break
            if all(c == 0 for c in done):
                break
            time.sleep(poll)
    finally:
        terminate_local_procs(procs)
        for p in procs:
            if getattr(p, "tee", None) is not None:
                p.tee.join(10)
            if getattr(p, "log", None):
                p.log.close()
    return code


def run_local_ranks(args):
    """Start and watch this node's ranks; a port the launcher chose
    (single node, no --master_port) that rank 0's store found taken is
    replaced by a new one and the ranks start again. Returns the exit
    code."""
    retry = args.master_port is None and args.nnodes == 1
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        procs = start_local_ranks(args.script, args.script_args,
                                  args.nproc_per_node, args.nnodes,
                                  args.node_rank, args.master_addr,
                                  args.master_port, args.log_dir)
        code = watch(procs)
        if code == 0 or not retry or not procs[0].addr_in_use.is_set() \
                or attempt == RENDEZVOUS_ATTEMPTS - 1:
            return code
        print(f"launch: rendezvous port {procs[0].port} was taken "  # cli-print
              f"(EADDRINUSE); starting the ranks again on a new port",
              file=sys.stderr, flush=True)
    return code


def main(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--nproc_per_node", type=int, default=None,
                        help="ranks to start on this host")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--master_addr", default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=None)
    parser.add_argument("--coordinator", default=None,
                        help="HOST:PORT of rank 0, one process a host")
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.nproc_per_node:
        sys.exit(run_local_ranks(args))
    if args.coordinator and args.num_processes > 1:
        host, port = args.coordinator.rsplit(":", 1)
        os.environ.update(PADDLE_COORDINATOR=args.coordinator,
                          PADDLE_TRAINERS_NUM=str(args.num_processes),
                          PADDLE_TRAINER_ID=str(args.process_id),
                          MASTER_ADDR=host, MASTER_PORT=port)
    sys.argv = [args.script] + args.script_args
    runpy.run_path(args.script, run_name="__main__")


if __name__ == "__main__":
    main()
