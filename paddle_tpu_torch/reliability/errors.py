"""Reliability exception types: the port's copy of
`paddle_tpu.reliability.errors`, unchanged.

These are deliberately dependency-free (stdlib only): they are raised
from the serving engine, caught by front-door streams, and matched by
client code, so they must be importable without touching torch or the
inference stack.
"""
from __future__ import annotations


class InjectedFault(RuntimeError):
    """A deterministic `FaultPlan` fault fired at an engine seam.

    Only ever raised when fault injection is explicitly enabled (ctor
    arg or PADDLE_TPU_FAULT_PLAN) — production servers never see it.
    """

    def __init__(self, seam, occurrence):
        self.seam = str(seam)
        self.occurrence = int(occurrence)
        super().__init__(
            f"injected fault at seam '{self.seam}' "
            f"(occurrence {self.occurrence})")


class QuarantinedRequest(RuntimeError):
    """The recovery ladder gave up on ONE request: after
    `RecoveryPolicy.quarantine_after` consecutive dispatch failures
    implicating it, the request's future fails with this diagnostic
    (naming the fault seam and the underlying error) while every
    co-resident request resumes token-identically."""

    def __init__(self, rid, seam, failures, cause):
        self.rid = str(rid)
        self.seam = str(seam)
        self.failures = int(failures)
        self.cause = cause
        super().__init__(
            f"request {self.rid} quarantined after {self.failures} "
            f"consecutive dispatch failure(s) implicating it at seam "
            f"'{self.seam}': {type(cause).__name__}: {cause}")


class RequestTimeout(RuntimeError):
    """A request exceeded its per-request `timeout_s` (queued or
    resident); its slot/blocks were freed and its stream terminates
    with reason="timeout"."""

    def __init__(self, rid, waited_s, timeout_s):
        self.rid = str(rid)
        self.waited_s = float(waited_s)
        self.timeout_s = float(timeout_s)
        super().__init__(
            f"request {self.rid} timed out after {self.waited_s:.3f}s "
            f"(timeout_s={self.timeout_s:g}); slot and blocks freed")


class ReplicaUnavailable(RuntimeError):
    """The fleet router could not place (or re-place) a request: no
    replica is routable — every replica is dead, circuit-open, or
    draining. For a request that was already streaming, this is the
    failover path's terminal error: its journaled state stays live in
    the router journal, so a later `recover_from_journal` on a healed
    fleet still completes it token-identically."""

    def __init__(self, rid, detail=""):
        self.rid = str(rid)
        self.detail = str(detail)
        super().__init__(
            f"no routable replica for request {self.rid}"
            + (f": {self.detail}" if self.detail else ""))


class AdmissionShed(RuntimeError):
    """Pool-pressure admission shedding: the submit was refused because
    the engine's queue depth crossed `shed_queue_depth`. Carries a
    `retry_after_s` hint (estimated from the current window's request
    latency and queue depth) that front ends can surface as an HTTP
    Retry-After."""

    def __init__(self, depth, shed_depth, retry_after_s):
        self.depth = int(depth)
        self.shed_depth = int(shed_depth)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"admission shed: {self.depth} requests queued (shed "
            f"threshold {self.shed_depth}); retry after "
            f"~{self.retry_after_s:.2f}s")
