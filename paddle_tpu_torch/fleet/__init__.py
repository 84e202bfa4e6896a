"""The serving fleet: the port's copy of `paddle_tpu.fleet` (host Python
over the engine's fleet hooks; nothing here launches a kernel).
Replicated `PagedGenerationServer` engines behind a failover
`FleetRouter` with journal-backed session takeover.

    from paddle_tpu_torch.fleet import FleetRouter, Replica

    reps = [Replica(f"r{i}", PagedGenerationServer(
                model, enable_prefix_cache=True, ...))
            for i in range(4)]
    router = FleetRouter(reps, journal="fleet.journal").start()
    fut = router.submit(ids)                  # placed prefix-aware
    h = router.submit(ids, stream=True)       # survives replica death
    router.migrate_session(rid, target="r2")  # zero-recompute move
    router.stop()

A replica dying mid-stream is a recoverable path: every accepted
request is journaled at the router (resolved seed, sampling, every
delivered token), the dead replica's sessions re-admit on survivors
through `PagedGenerationServer.admit_journal_entry`, and the
deterministic decode stack resumes them at PRNG step len(gen0), so the
completed output is token-identical to a run that was never
interrupted. `RemoteReplica` runs a replica as an OS process behind a
stdlib HTTP wire (`python -m paddle_tpu_torch.fleet.transport`),
`DisaggRouter` splits prefill and decode pools, `FleetLanes` puts the
front door's `LaneScheduler` above placement, and `Autoscaler` grows
and shrinks the fleet. Every replica's engine runs K1 on its packed
prefills and K2 in its decode graph; an imported migration payload is
pool blocks that K1 and K2 then read through the block tables.
"""
from ..reliability import ReplicaUnavailable  # noqa: F401 (re-export)
from .autoscale import (Autoscaler, AutoscalePolicy,  # noqa: F401
                        ScaleDecision)
from .disagg import DisaggRouter, FleetLanes  # noqa: F401
from .federation import (add_label_to_prom_text,  # noqa: F401
                         federate_metrics, http_fetcher)
from .health import ReplicaHealth  # noqa: F401
from .migration import (deserialize_kv_payload,  # noqa: F401
                        serialize_kv_payload)
from .replica import Replica  # noqa: F401
from .router import FleetRouter  # noqa: F401
from .transport import RemoteEngine, RemoteReplica  # noqa: F401

__all__ = [
    "FleetRouter", "Replica", "ReplicaHealth", "ReplicaUnavailable",
    "RemoteEngine", "RemoteReplica", "DisaggRouter", "FleetLanes",
    "Autoscaler", "AutoscalePolicy", "ScaleDecision",
    "federate_metrics", "add_label_to_prom_text", "http_fetcher",
    "serialize_kv_payload", "deserialize_kv_payload",
]
