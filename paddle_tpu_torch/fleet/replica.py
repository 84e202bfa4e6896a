"""One fleet replica: a `PagedGenerationServer` plus its health state
and the probe surface the router reads: the port's copy of
`paddle_tpu.fleet.replica`.

A replica owns its OWN engine, paged pool, optional journal and ops
plane — the router never reaches into engine internals except
through the replica-facing hooks (`submit`, `admit_journal_entry`,
`export_session`, `import_kv_payload`, `liveness`/`readiness`,
`cache.match_prefix_len`). Replicas here are in-process (each engine
already runs its own loop thread); the probe/dispatch surface is
deliberately the same one a subprocess replica would expose over
HTTP, so the router logic does not care which it is.
"""
from __future__ import annotations

import threading

from ..observability import log as _obs_log
from .health import ReplicaHealth

_logger = _obs_log.get_logger(__name__)


class Replica:
    """Router-facing wrapper of one serving engine.

    name: stable replica id — the `replica` label on federated
        metrics and the key in router stats.
    server: a NOT-yet-started `PagedGenerationServer` (the router
        starts and stops the fleet).
    health: a `ReplicaHealth` (default-constructed when omitted).
    """

    def __init__(self, name, server, health=None):
        self.name = str(name)
        self.server = server
        self.health = health if health is not None else ReplicaHealth()
        # causal tracing: the engine stamps its trace
        # events/spans/ring entries with this name, so the shared
        # in-process span sink still attributes per replica
        server.trace_name = self.name
        self._killed = False
        self._started = False
        self._lock = threading.Lock()

    # ---- lifecycle -----------------------------------------------------
    def start(self):
        with self._lock:
            if not self._started:
                self.server.start()
                self._started = True
        return self

    def stop(self):
        with self._lock:
            if self._started and not self._killed:
                self.server.stop()
            self._started = False

    def kill(self):
        """Crash-simulation: hard-stop the engine WITHOUT resolving
        its futures (`PagedGenerationServer.kill`) and mark the
        replica dead — the router's replica_kill seam and the chaos
        tests land here."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        self.health.mark_dead("killed")
        self.server.kill()
        _logger.warning("replica %s killed", self.name)

    @property
    def dead(self):
        return self._killed or self.health.state == "dead"

    # ---- probe surface -------------------------------------------------
    def liveness(self):
        if self._killed:
            return False, {"engine_running": False, "killed": True}
        return self.server.liveness()

    def readiness(self):
        if self._killed:
            return False, {"killed": True}
        return self.server.readiness()

    def set_draining(self, draining=True):
        """Drain toggle passthrough (the scale-down state machine's
        first step): readiness flips false while resident sessions
        keep decoding to completion."""
        self.server.set_draining(bool(draining))
        return self

    def load(self):
        """Instantaneous placement load: busy slots + queued requests
        (lock-free int reads — staleness only skews a tiebreak)."""
        srv = self.server
        busy = sum(1 for s in srv._slots if s is not None)
        sched = srv._sched
        try:
            depth = (sched.depth() if sched is not None
                     else len(srv._queue))
        except Exception:  # noqa: BLE001 — a torn-down scheduler
            depth = 0
        return busy + depth

    def queue_depth(self):
        srv = self.server
        try:
            return (srv._sched.depth() if srv._sched is not None
                    else len(srv._queue))
        except Exception:  # noqa: BLE001
            return 0

    def prefix_match_len(self, ids):
        """The placement signal: how many tokens of `ids` this
        replica's content-addressed cache already holds (0 when its
        prefix cache is off or it is dead)."""
        if self.dead or not self.server.enable_prefix_cache:
            return 0
        try:
            return self.server.cache.match_prefix_len(ids)
        except Exception:  # noqa: BLE001 — placement is advisory
            return 0

    def capacity(self):
        """This replica's versioned pressure snapshot — the
        per-replica feed `FleetRouter.capacity()` federates. Raises on
        a dead replica; the federation layer converts that into the
        snapshot's `{"error": ...}` slot (dead-source tolerance)."""
        if self.dead:
            raise RuntimeError(f"replica {self.name} is dead")
        return self.server.capacity_snapshot()

    def metrics_text(self):
        """This replica's Prometheus page for federation. In-process
        replicas share the process registry (their per-pool series are
        disambiguated by the `pool` label); a subprocess replica would
        serve its own registry here — the federation layer treats both
        as opaque text."""
        from ..observability import metrics as _metrics

        return _metrics.REGISTRY.to_prometheus()

    def stats(self):
        live, _ = self.liveness()
        ready, _ = self.readiness()
        return {
            "name": self.name,
            "health": self.health.stats(),
            "live": live,
            "ready": ready,
            "load": 0 if self.dead else self.load(),
            "queue_depth": 0 if self.dead else self.queue_depth(),
        }
