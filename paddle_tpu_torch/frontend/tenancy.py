"""Multi-tenant admission primitives for the front door: the port's copy of
`paddle_tpu.frontend.tenancy`.

A TENANT is a fair-share and rate-limit accounting bucket: every
front-door request names one, and the scheduler (`LaneScheduler`)
queues, throttles, and weighs requests per tenant. This module holds
the pure-policy pieces so they are unit-testable with a fake clock:

  * `TenantConfig` — declarative per-tenant policy (weight for the
    fair-share scheduler, token rate limit, bounded queue depth).
  * `TokenBucket` — deterministic token-bucket rate limiter. Time is
    always passed IN (`now`), never read from a wall clock, so the
    scheduler's single `time.perf_counter()` per admission pass drives
    every bucket and tests can replay exact schedules.
  * `QueueFull` — the EXPLICIT rejection: raised at submit time when a
    bounded tenant/global queue is full. Rate limits never reject —
    they delay (the request stays queued but ineligible until the
    bucket refills); only bounded queues reject.
"""
from __future__ import annotations

from dataclasses import dataclass


class QueueFull(RuntimeError):
    """Submit rejected: the tenant's (or the global) bounded queue is
    full. Nothing was enqueued; the caller may retry later."""


@dataclass
class TenantConfig:
    """Per-tenant front-door policy.

    weight: fair-share weight inside the batch lane (stride
        scheduling: a tenant with weight 2 is served twice as often as
        a weight-1 tenant under contention).
    rate_tokens_per_s: token-rate limit charged at ADMISSION with the
        request's cost (prompt tokens + token budget). None = no limit.
    burst_tokens: bucket capacity (how far ahead of the steady rate a
        quiet tenant may burst). Defaults to 4x the rate — and a
        request costing more than the burst is still admittable at a
        full bucket (the bucket goes into debt and repays at the
        steady rate), so no request is unschedulable by construction.
    max_queued: bounded queue depth; a submit past it raises
        `QueueFull`. None = unbounded.
    """
    name: str = "default"
    weight: float = 1.0
    rate_tokens_per_s: float | None = None
    burst_tokens: float | None = None
    max_queued: int | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"> 0, got {self.weight}")
        if self.rate_tokens_per_s is not None \
                and self.rate_tokens_per_s <= 0:
            raise ValueError(
                f"tenant {self.name!r}: rate_tokens_per_s must be > 0 "
                f"or None, got {self.rate_tokens_per_s}")
        if self.max_queued is not None and self.max_queued < 1:
            raise ValueError(f"tenant {self.name!r}: max_queued must "
                             f"be >= 1 or None, got {self.max_queued}")


class TokenBucket:
    """Deterministic token bucket. All methods take `now` explicitly
    (any monotonic float clock); the bucket starts full at the first
    call's timestamp. `charge` may drive the level negative (debt) —
    `affords` then stays False until the refill repays it, which is
    what lets a single request larger than the burst through without
    permanently starving it."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self._level = self.burst
        self._t = None

    def _refill(self, now):
        if self._t is None:
            self._t = float(now)
        dt = max(0.0, float(now) - self._t)
        self._level = min(self.burst, self._level + dt * self.rate)
        self._t = float(now)

    @property
    def level(self):
        return self._level

    def affords(self, cost, now):
        """Whether a request costing `cost` tokens may be admitted
        now: the level covers the cost, OR the bucket is full (so an
        over-burst-sized request runs on debt instead of starving)."""
        self._refill(now)
        return (self._level >= float(cost)
                or self._level >= self.burst)

    def charge(self, cost, now):
        self._refill(now)
        self._level -= float(cost)
