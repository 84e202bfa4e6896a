"""Recovery ladder policy: the port's copy of
`paddle_tpu.reliability.recovery`, unchanged.

The POLICY half of engine recovery: how many consecutive failures may
implicate one request before it is quarantined, and how long the
engine backs off between retry rounds. The MECHANISM (snapshotting
implicated slots through the swap-out/publish machinery, requeueing,
rebuilding dispatch state) lives in `inference.serving` — it needs the
engine's internals; this object is pure arithmetic, deterministic and
unit-testable.

Ladder semantics (docs/RELIABILITY.md):

  1. A dispatch failure never fails a future outright. Every
     implicated request is snapshotted (generated-so-far tokens +
     resume prompt; live K/V published through the prefix-cache index
     when caching is on) and requeued at the FRONT of its queue.
  2. The engine sleeps `backoff_s(consecutive_failures)` — capped
     exponential — then the normal admission path retries.
  3. A request implicated in `quarantine_after` consecutive failures
     is QUARANTINED: its future fails with `QuarantinedRequest`
     (naming the seam and the underlying error) and at most ONE
     request is quarantined per failure (highest streak first, lowest
     slot index on ties), so a fault caused by a single poisoned
     request costs exactly that request.
  4. The first successful dispatch after >= 1 failure is a CLEAN
     RECOVERY: health returns degraded -> ok, the recovery is counted
     and timestamped, and the streaks of the dispatched requests
     reset.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs of the recovery ladder.

    quarantine_after: consecutive failing dispatches implicating the
        same request before that request is quarantined (>= 1).
    backoff_base_s / backoff_cap_s: capped exponential backoff between
        retry rounds — failure k sleeps
        min(cap, base * 2**(k-1)) seconds.
    """

    quarantine_after: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 1.0

    def __post_init__(self):
        if int(self.quarantine_after) < 1:
            raise ValueError(f"quarantine_after must be >= 1, "
                             f"got {self.quarantine_after}")
        if float(self.backoff_base_s) < 0:
            raise ValueError(f"backoff_base_s must be >= 0, "
                             f"got {self.backoff_base_s}")
        if float(self.backoff_cap_s) < float(self.backoff_base_s):
            raise ValueError(
                f"backoff_cap_s ({self.backoff_cap_s}) must be >= "
                f"backoff_base_s ({self.backoff_base_s})")

    def backoff_s(self, consecutive_failures):
        """Sleep before the retry that follows failure number
        `consecutive_failures` (1-based)."""
        k = max(1, int(consecutive_failures))
        return min(float(self.backoff_cap_s),
                   float(self.backoff_base_s) * 2.0 ** (k - 1))
