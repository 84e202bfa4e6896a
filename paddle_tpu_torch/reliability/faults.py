"""Deterministic fault injection for the serving engine: the port's
copy of `paddle_tpu.reliability.faults` (the same seed gives the same
schedule: `from_seed` draws from `np.random.RandomState` as the
reference does).

A `FaultPlan` is a FIXED schedule of faults keyed by (named seam,
occurrence index): the Nth time the engine reaches seam S, the plan
either raises, simulates pool exhaustion, or sleeps — and an identical
plan replayed against an identical workload fires at exactly the same
points. That determinism is what makes the chaos parity gate testable:
the faulted run's surviving requests can be compared token-for-token
against the fault-free run.

Seams (the engine's hazard points — see docs/RELIABILITY.md):

  prefill / decode / verify / unified_round
      raise `InjectedFault` immediately before the corresponding
      dispatch's launches (the device tensors are untouched, so
      recovery is exact);
  ensure_many
      raise `kv_cache.BlockPoolExhausted` immediately before the
      round's bulk block allocation;
  slow_dispatch
      sleep `delay_s` inside the dispatch path — visible to the stall
      watchdog, recovers on its own (no raise);
  detokenize
      raise inside the host-side stop-string check (exercises the
      engine's per-request detokenizer guard);
  stream_consumer
      raise in place of the request's `on_token` callback (exercises
      the engine's stream-isolation guard — generation continues).
  replica_kill
      a FLEET-level seam: polled by `fleet.FleetRouter` once per
      placement decision, never by the engine. When it fires, the
      router hard-kills the chosen replica (`kill()` — the crash
      simulation, no futures resolved) and fails its resident sessions
      over to survivors via the router journal. Give the router its
      own plan: seam occurrence counters are plan state, and sharing
      one plan between the router and its replicas would interleave
      their counters nondeterministically.

Plans come from three places: an explicit `Fault` list, a fixed seed
(`FaultPlan.from_seed` — Bernoulli(rate) per occurrence up to
`horizon`, optionally forcing at least one fault per seam), or the
`PADDLE_TPU_FAULT_PLAN` environment variable (`FaultPlan.parse`). A
server built without a plan pays ONE `is None` check per seam.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from .errors import InjectedFault

ENV_FAULT_PLAN = "PADDLE_TPU_FAULT_PLAN"

#: every seam an injection point exists for (replica_kill is polled by
#: the fleet router; the rest by the engine).
SEAMS = ("prefill", "decode", "verify", "unified_round", "ensure_many",
         "slow_dispatch", "detokenize", "stream_consumer",
         "replica_kill")

#: seams whose fault is not a plain raise.
_SEAM_KIND = {"ensure_many": "exhausted", "slow_dispatch": "slow"}

KINDS = ("raise", "exhausted", "slow")


def default_kind(seam):
    """The fault kind a seam injects unless overridden."""
    return _SEAM_KIND.get(seam, "raise")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire at occurrence `index` of `seam`."""
    seam: str
    index: int
    kind: str = "raise"
    delay_s: float = 0.25

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r} "
                             f"(seams: {SEAMS})")
        if self.index < 0:
            raise ValueError(f"fault index must be >= 0, "
                             f"got {self.index}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(kinds: {KINDS})")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


class FaultPlan:
    """A deterministic seam x occurrence fault schedule.

    faults: iterable of `Fault` (or (seam, index) pairs — the kind then
        defaults per seam: ensure_many -> exhausted, slow_dispatch ->
        slow, everything else -> raise).
    name: short label for stats()/flight-recorder lines.

    `poll(seam)` is the engine-side primitive: it increments the seam's
    occurrence counter and returns the scheduled `Fault` for this
    occurrence (or None). The plan is reusable across servers only
    after `reset_counters()` — occurrence counters are plan state, not
    server state, so one plan drives one measured run.
    """

    def __init__(self, faults=(), name="explicit", slow_s=0.25):
        self._sched: dict[str, dict[int, Fault]] = {}
        n = 0
        for f in faults:
            if not isinstance(f, Fault):
                seam, index = f
                f = Fault(str(seam), int(index),
                          kind=default_kind(str(seam)),
                          delay_s=float(slow_s))
            self._sched.setdefault(f.seam, {})[f.index] = f
            n += 1
        self.name = str(name)
        self._total = sum(len(d) for d in self._sched.values())
        self._lock = threading.Lock()
        self._count = dict.fromkeys(self._sched, 0)
        self._fired: dict[str, int] = {}

    # -- construction ----------------------------------------------------
    @classmethod
    def from_seed(cls, seed, *, seams=SEAMS, rate=0.05, horizon=64,
                  min_per_seam=0, slow_s=0.25):
        """Fixed-seed Bernoulli schedule: each of the first `horizon`
        occurrences of each seam faults with probability `rate`;
        `min_per_seam` >= 1 forces at least that many faults per seam
        (the chaos gate's "every seam fires" requirement) at
        deterministically drawn indices."""
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if int(horizon) < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        rng = np.random.RandomState(int(seed))
        faults = []
        for seam in seams:
            if seam not in SEAMS:
                raise ValueError(f"unknown fault seam {seam!r} "
                                 f"(seams: {SEAMS})")
            idx = set(np.flatnonzero(
                rng.rand(int(horizon)) < float(rate)).tolist())
            while len(idx) < int(min_per_seam):
                idx.add(int(rng.randint(int(horizon))))
            faults.extend(
                Fault(seam, i, kind=default_kind(seam),
                      delay_s=float(slow_s)) for i in sorted(idx))
        return cls(faults, name=f"seed={int(seed)},rate={float(rate)}",
                   slow_s=slow_s)

    @classmethod
    def parse(cls, spec):
        """Parse the PADDLE_TPU_FAULT_PLAN string form. Two formats:

        seeded    — "seed=7,rate=0.05,horizon=64,min=1[,slow=0.25]
                     [,seams=decode+prefill]"
        explicit  — "decode:2,prefill:0,ensure_many:1" (seam:occurrence
                     pairs, kind defaulting per seam)
        """
        spec = str(spec).strip()
        if not spec:
            raise ValueError("empty fault-plan spec")
        if "=" in spec:
            kv = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError(
                        f"bad fault-plan field {part!r} in seeded spec "
                        f"{spec!r} (expected key=value)")
                k, v = part.split("=", 1)
                kv[k.strip()] = v.strip()
            known = {"seed", "rate", "horizon", "min", "slow", "seams"}
            bad = set(kv) - known
            if bad:
                raise ValueError(f"unknown fault-plan key(s) "
                                 f"{sorted(bad)} (known: "
                                 f"{sorted(known)})")
            if "seed" not in kv:
                raise ValueError(f"seeded fault-plan spec {spec!r} "
                                 f"needs seed=")
            seams = (tuple(kv["seams"].split("+")) if "seams" in kv
                     else SEAMS)
            return cls.from_seed(
                int(kv["seed"]), seams=seams,
                rate=float(kv.get("rate", 0.05)),
                horizon=int(kv.get("horizon", 64)),
                min_per_seam=int(kv.get("min", 0)),
                slow_s=float(kv.get("slow", 0.25)))
        faults = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) != 2:
                raise ValueError(
                    f"bad fault-plan entry {part!r} in {spec!r} "
                    f"(expected seam:occurrence)")
            faults.append((bits[0], int(bits[1])))
        return cls(faults, name=spec)

    # -- engine side -----------------------------------------------------
    def poll(self, seam):
        """Advance `seam`'s occurrence counter; return the `Fault`
        scheduled for this occurrence, or None. The caller (the
        engine's `_maybe_fault`) turns the fault into its effect."""
        with self._lock:
            i = self._count.get(seam, 0)
            self._count[seam] = i + 1
            f = self._sched.get(seam, {}).get(i)
            if f is not None:
                self._fired[seam] = self._fired.get(seam, 0) + 1
            return f

    def make_fault(self, f):
        """The exception a raising fault injects (`poll` returns the
        Fault; the engine raises). Split out so `ensure_many` can map
        to the pool's own exception type without this module importing
        the inference stack."""
        return InjectedFault(f.seam, f.index)

    # -- introspection ---------------------------------------------------
    def reset_counters(self):
        """Zero the occurrence counters (reuse one plan for a second
        measured run); the schedule itself is immutable."""
        with self._lock:
            self._count = dict.fromkeys(self._sched, 0)
            self._fired = {}

    def describe(self):
        return self.name

    @property
    def total_scheduled(self):
        return self._total

    def fired(self):
        """{seam: faults fired so far} — the chaos gate's evidence that
        every seam actually injected."""
        with self._lock:
            return dict(self._fired)

    def stats(self):
        with self._lock:
            return {
                "name": self.name,
                "scheduled": self._total,
                "fired": sum(self._fired.values()),
                "fired_by_seam": dict(self._fired),
                "occurrences": dict(self._count),
            }


def resolve_fault_plan(arg):
    """Engine-ctor normalization: None -> the PADDLE_TPU_FAULT_PLAN
    env var (unset/empty -> no plan), a spec string -> parsed plan, a
    FaultPlan -> itself."""
    if arg is None:
        spec = os.environ.get(ENV_FAULT_PLAN, "")
        return FaultPlan.parse(spec) if spec else None
    if isinstance(arg, FaultPlan):
        return arg
    if isinstance(arg, str):
        return FaultPlan.parse(arg)
    raise TypeError(f"fault_plan must be a FaultPlan, spec string or "
                    f"None, got {type(arg).__name__}")
