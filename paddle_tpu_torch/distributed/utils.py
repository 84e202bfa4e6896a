"""Launcher helpers: the port of `paddle_tpu/distributed/utils.py` — the
Cluster / Pod / Trainer description of a job, endpoint assembly,
free-port discovery and process teardown. A trainer is one process (one
rank of torch.distributed); its `accelerators` are the card slots it
was given.
"""
from __future__ import annotations

import logging
import socket
import time


def get_logger(log_level=20, name="root"):
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    return logger


class Trainer:
    def __init__(self):
        self.accelerators = []
        self.endpoint = None
        self.rank = None

    def __str__(self):
        return (f"accelerators:{self.accelerators} "
                f"endpoint:{self.endpoint} rank:{self.rank}")


class Pod:
    def __init__(self):
        self.rank = None
        self.id = None
        self.addr = None
        self.port = None
        self.trainers = []

    def __str__(self):
        return (f"rank:{self.rank} id:{self.id} addr:{self.addr} "
                f"port:{self.port} trainers:{len(self.trainers)}")


class Cluster:
    def __init__(self, hdfs=None):
        self.job_server = None
        self.pods = []
        self.hdfs = hdfs

    def trainers_nranks(self):
        return len(self.trainers_endpoints())

    def trainers_endpoints(self):
        return [t.endpoint for pod in self.pods for t in pod.trainers]

    def pods_endpoints(self):
        return [f"{pod.addr}:{pod.port}" for pod in self.pods]

    def world_device_ids(self):
        return [t.accelerators for pod in self.pods for t in pod.trainers]


def get_cluster(node_ips, node_ip, trainer_endpoints, device_ids_per_node):
    """Build a Cluster/Pod/Trainer tree: a pod per node ip, a trainer per
    slot of device_ids_per_node on it (ranks in order)."""
    cluster = Cluster()
    rank = 0
    for pod_rank, ip in enumerate(node_ips):
        pod = Pod()
        pod.rank = pod_rank
        pod.id = pod_rank
        pod.addr = ip
        eps = trainer_endpoints[pod_rank] \
            if isinstance(trainer_endpoints[0], (list, tuple)) \
            else [e for e in trainer_endpoints
                  if e.split(":")[0] == ip]
        for slot, ep in zip(device_ids_per_node, eps):
            t = Trainer()
            t.accelerators = [slot] if not isinstance(slot, (list, tuple)) \
                else list(slot)
            t.endpoint = ep
            t.rank = rank
            rank += 1
            pod.trainers.append(t)
        cluster.pods.append(pod)
    pod = cluster.pods[node_ips.index(node_ip)] if node_ip in node_ips \
        else cluster.pods[0]
    return cluster, pod


def get_host_name_ip():
    try:
        host = socket.gethostname()
        return host, socket.gethostbyname(socket.getfqdn(host))
    except Exception:
        return None


def _ephemeral_low():
    """The low end of the kernel's ephemeral port range (32768 when it
    cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port(host="127.0.0.1", exclude=()):
    """A free TCP port for a rendezvous: drawn at random below the
    kernel's ephemeral range and checked by binding it. A port the kernel
    hands out for port 0 lies inside that range, where any other
    process's outgoing connection can take it before rank 0's store binds
    it; below the range only a listener can."""
    import random
    low = _ephemeral_low()
    rng = random.Random()
    while True:
        port = rng.randrange(max(1024, low - 12000), low)
        if port in exclude:
            continue
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
            return port


def is_addr_in_use(text):
    """Whether `text` (a rank's output or traceback) reports that rank
    0's store could not bind its port."""
    low = text.lower()
    return "eaddrinuse" in low or "address already in use" in low


def find_free_ports(num):
    """`num` distinct free TCP ports (each by `free_port`)."""
    ports = set()
    while len(ports) < num:
        ports.add(free_port("", exclude=ports))
    return ports


def terminate_local_procs(procs):
    """Terminate launcher-spawned processes: TERM, up to 10 s of grace,
    then KILL."""
    for p in procs:
        proc = getattr(p, "proc", p)
        if proc.poll() is None:
            proc.terminate()
    deadline = time.time() + 10
    for p in procs:
        proc = getattr(p, "proc", p)
        while proc.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if proc.poll() is None:
            proc.kill()


def add_arguments(argname, type, default, help, argparser, **kwargs):  # noqa: A002,E501
    argparser.add_argument("--" + argname, default=default, type=type,
                           help=help + f" Default: %(default)s.", **kwargs)


__all__ = ["get_logger", "Cluster", "Pod", "Trainer", "get_cluster",
           "get_host_name_ip", "find_free_ports", "free_port",
           "is_addr_in_use", "terminate_local_procs",
           "add_arguments"]
