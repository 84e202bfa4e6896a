"""Fault-tolerant serving: deterministic fault injection, dispatch
recovery with request quarantine, and the crash-consistent session
journal. The port's copy of `paddle_tpu.reliability` (pure host Python:
stdlib and numpy).

Three layers:

  * `FaultPlan` — a fixed-seed schedule of faults by named seam x
    occurrence index, wired through explicit injection points at the
    engine's hazard seams (`PagedGenerationServer(fault_plan=...)` or
    the PADDLE_TPU_FAULT_PLAN env var; one `is None` check when off);
  * `RecoveryPolicy` — the recovery ladder the engine runs instead of
    failing every request of a failed dispatch: snapshot implicated
    requests through the swap-out/publish machinery, requeue, retry
    with capped exponential backoff, and quarantine a request only
    after it is implicated in N consecutive failures;
  * `SessionJournal` — a bounded append-only record of accepted
    requests + emitted tokens from which a fresh engine re-admits
    whatever a crash interrupted
    (`PagedGenerationServer.recover_from_journal`).

The package imports neither torch nor the inference stack, so its
exceptions and plans can be used anywhere without pulling in the
engine.
"""
from .errors import (AdmissionShed, InjectedFault, QuarantinedRequest,
                     ReplicaUnavailable, RequestTimeout)
from .faults import (ENV_FAULT_PLAN, SEAMS, Fault, FaultPlan,
                     resolve_fault_plan)
from .journal import SessionJournal
from .recovery import RecoveryPolicy

__all__ = [
    "AdmissionShed", "InjectedFault", "QuarantinedRequest",
    "ReplicaUnavailable", "RequestTimeout", "ENV_FAULT_PLAN", "SEAMS",
    "Fault", "FaultPlan", "resolve_fault_plan", "SessionJournal",
    "RecoveryPolicy",
]
