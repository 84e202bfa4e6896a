"""SLO-lane / multi-tenant scheduler for `PagedGenerationServer`:
the port's copy of `paddle_tpu.frontend.scheduler`.

The engine stays mechanism-only (reservation admission, packed chunk
prefill, preemption swap-out); this module is the POLICY it consults
when a scheduler is installed (`server.set_scheduler(...)`):

  * Two SLO lanes — "interactive" (TTFT-sensitive; ordered earliest-
    deadline-first) and "batch" (throughput; ordered by per-tenant
    stride fair share). Lane service is weighted (default 4:1
    interactive:batch) via served/weight counters, so neither lane
    starves; a lane whose head candidate is blocked on resources is
    set aside for the pass instead of head-of-line-blocking the other
    lane.
  * Multi-tenancy — per-tenant FIFO queues inside each lane, stride
    scheduling across tenants by `TenantConfig.weight`, token-bucket
    rate limits (throttled tenants stay queued but ineligible — delay,
    not rejection), and bounded queues with EXPLICIT rejection
    (`QueueFull` raised at submit, counted).
  * Preemption policy — when an interactive candidate is blocked on a
    slot or blocks, `victims()` names batch-lane slots newest-first;
    interactive never preempts interactive, batch never preempts
    anyone, and a candidate WAITS instead of preempting while some
    resident is within `preempt_wait_tokens` of finishing (drain-wait
    hysteresis — unless the candidate's deadline already passed). The
    engine performs the swap-out and calls `requeue`, which puts the
    victim at the FRONT of its tenant queue.
  * Prefill chunk sharing — `prefill_plan` orders feeding slots
    interactive-(EDF)-first and, when both lanes are feeding, caps the
    interactive lane at `interactive_chunk_share` of the chunk budget
    so batch prompts keep a guaranteed share and interactive keeps its
    latency priority.

All methods that read time take `now` explicitly (the engine passes
one `time.perf_counter()` per pass), so the whole policy is
deterministic under test. Engine calls arrive under the server lock.
"""
from __future__ import annotations

from collections import deque

from ..inference.serving import RequestMeta
from ..observability import metrics as _metrics
from .tenancy import QueueFull, TenantConfig, TokenBucket

LANES = ("interactive", "batch")

_m_lane_queue = _metrics.gauge(
    "serving_lane_queue_depth",
    "queued requests per SLO lane (front-door scheduler)",
    labelnames=("lane",))
_m_tenant_queue = _metrics.gauge(
    "serving_tenant_queue_depth",
    "queued requests per tenant (front-door scheduler)",
    labelnames=("tenant",))
_m_rejected = _metrics.counter(
    "frontdoor_rejected_total",
    "submits rejected by a bounded queue (tenant or global)",
    labelnames=("why",))
_m_throttled = _metrics.counter(
    "frontdoor_throttled_skips_total",
    "admission passes that skipped a tenant because its token bucket "
    "could not afford its head request (delay, not rejection)",
    labelnames=("tenant",))


class _TenantState:
    __slots__ = ("cfg", "bucket", "vtime", "queued")

    def __init__(self, cfg):
        self.cfg = cfg
        self.bucket = None
        if cfg.rate_tokens_per_s is not None:
            burst = (cfg.burst_tokens if cfg.burst_tokens is not None
                     else 4.0 * cfg.rate_tokens_per_s)
            self.bucket = TokenBucket(cfg.rate_tokens_per_s, burst)
        self.vtime = 0.0   # stride-scheduling virtual time
        self.queued = 0    # across both lanes


class LaneScheduler:
    """The policy object `PagedGenerationServer` consults (see module
    docstring). Construct directly for tests, or let `FrontDoor` build
    and install it."""

    def __init__(self, tenants=None, *, lane_weights=None,
                 interactive_chunk_share=0.7, preemption=True,
                 preempt_wait_tokens=8, max_queue=None,
                 auto_tenants=None):
        self._weights = dict(lane_weights or {"interactive": 4.0,
                                              "batch": 1.0})
        for lane in LANES:
            if self._weights.get(lane, 0) <= 0:
                raise ValueError(f"lane_weights[{lane!r}] must be > 0")
        if not 0.0 < float(interactive_chunk_share) <= 1.0:
            raise ValueError("interactive_chunk_share must be in "
                             f"(0, 1], got {interactive_chunk_share}")
        self.interactive_chunk_share = float(interactive_chunk_share)
        self.preemption = bool(preemption)
        if int(preempt_wait_tokens) < 0:
            raise ValueError("preempt_wait_tokens must be >= 0, got "
                             f"{preempt_wait_tokens}")
        self.preempt_wait_tokens = int(preempt_wait_tokens)
        self.max_queue = None if max_queue is None else int(max_queue)
        self._tenants: dict[str, _TenantState] = {}
        explicit = tenants is not None
        for cfg in (tenants or ()):
            if isinstance(tenants, dict):
                cfg = tenants[cfg]
            if not isinstance(cfg, TenantConfig):
                raise TypeError(f"tenants entries must be TenantConfig,"
                                f" got {type(cfg).__name__}")
            self._tenants[cfg.name] = _TenantState(cfg)
        # explicit tenant roster = closed world (unknown tenants are a
        # config error); no roster = tenants appear on first use
        self.auto_tenants = (not explicit if auto_tenants is None
                             else bool(auto_tenants))
        self._q: dict[str, dict[str, deque]] = {ln: {} for ln in LANES}
        self._depth = 0
        self._served = dict.fromkeys(LANES, 0.0)
        self._rejected = 0
        self._throttled = 0

    # ---- tenant registry ------------------------------------------------
    def tenant(self, name):
        ts = self._tenants.get(name)
        if ts is None:
            if not self.auto_tenants:
                raise ValueError(
                    f"unknown tenant {name!r} (known: "
                    f"{sorted(self._tenants)}); pass a TenantConfig "
                    f"for it or enable auto_tenants")
            ts = _TenantState(TenantConfig(name=name))
            self._tenants[name] = ts
        return ts

    # ---- submission ------------------------------------------------------
    def on_submit(self, req, now):
        """Route one request into its lane/tenant queue. Raises
        `QueueFull` (nothing enqueued) when a bounded queue is full —
        the explicit-rejection satellite of the bounded-queue design."""
        if req.meta is None:
            # bare server.submit on a fronted server: default lane /
            # tenant, cost = prompt + budget
            req.meta = RequestMeta(cost=int(req.ids.size + req.budget))
        meta = req.meta
        if meta.lane not in LANES:
            raise ValueError(f"unknown lane {meta.lane!r} "
                             f"(lanes: {LANES})")
        ts = self.tenant(meta.tenant)
        if not meta.cost:
            meta.cost = int(req.ids.size + req.budget)
        if self.max_queue is not None and self._depth >= self.max_queue:
            self._rejected += 1
            _m_rejected.labels(why="global").inc()
            raise QueueFull(
                f"front-door queue full ({self._depth}/"
                f"{self.max_queue} queued)")
        if ts.cfg.max_queued is not None \
                and ts.queued >= ts.cfg.max_queued:
            self._rejected += 1
            _m_rejected.labels(why="tenant").inc()
            raise QueueFull(
                f"tenant {meta.tenant!r} queue full ({ts.queued}/"
                f"{ts.cfg.max_queued} queued)")
        self._q[meta.lane].setdefault(meta.tenant,
                                      deque()).append(req)
        ts.queued += 1
        self._depth += 1
        self._push_gauges(meta.lane, meta.tenant)

    def requeue(self, req, now):
        """A preempted request returns to the FRONT of its tenant
        queue (it resumes before tenant-mates that never ran); its
        rate cost was charged at first admission and is not charged
        again."""
        meta = req.meta
        ts = self.tenant(meta.tenant)
        self._q[meta.lane].setdefault(meta.tenant,
                                      deque()).appendleft(req)
        ts.queued += 1
        self._depth += 1
        self._push_gauges(meta.lane, meta.tenant)

    # ---- candidate selection --------------------------------------------
    def _lane_head(self, lane, now):
        """Best eligible request in `lane`: interactive = earliest
        deadline first (undated requests after dated ones, FIFO among
        themselves); batch = head of the min-vtime eligible tenant.
        Rate-throttled tenants are skipped (and counted) — delay, not
        rejection."""
        best = None
        best_key = None
        for tname, dq in self._q[lane].items():
            if not dq:
                continue
            head = dq[0]
            ts = self._tenants[tname]
            if ts.bucket is not None and not getattr(
                    head, "_fd_charged", False) \
                    and not ts.bucket.affords(head.meta.cost, now):
                self._throttled += 1
                _m_throttled.labels(tenant=tname).inc()
                continue
            if lane == "interactive":
                dl = head.meta.deadline_s
                key = (0, req_deadline(head), head.t_submit) \
                    if dl is not None else (1, 0.0, head.t_submit)
            else:
                key = (ts.vtime, head.t_submit)
            if best is None or key < best_key:
                best, best_key = head, key
        return best

    def next_request(self, now, blocked=()):
        """The engine's admission probe: the best candidate across
        non-blocked lanes, weighted by lane service counters
        (served/weight — the lane that is furthest behind its weight
        goes first). Returns the request WITHOUT removing it; the
        engine calls `pop` once the reservation holds."""
        lanes = [ln for ln in LANES if ln not in blocked]
        lanes.sort(key=lambda ln: (self._served[ln]
                                   / self._weights[ln],
                                   LANES.index(ln)))
        for lane in lanes:
            head = self._lane_head(lane, now)
            if head is not None:
                return head
        return None

    def peek(self, now, n):
        """Up to `n` queued requests in approximate admission order
        WITHOUT popping, charging rate buckets, or counting throttle
        skips — the tier-prefetch tick's lane-aware look-ahead.
        Order is advisory: lanes rank by their current
        served/weight counters, interactive requests EDF across
        tenants, batch tenants by stride vtime then FIFO — the same
        keys `next_request` uses, minus the per-admission counter
        advances, so the set of likely-next requests is right even
        when the exact interleave shifts by the time they admit."""
        n = int(n)
        if n <= 0 or self._depth == 0:
            return []
        lanes = sorted(LANES, key=lambda ln: (self._served[ln]
                                              / self._weights[ln],
                                              LANES.index(ln)))
        out = []
        for lane in lanes:
            if len(out) >= n:
                break
            if lane == "interactive":
                entries = []
                for tname, dq in self._q[lane].items():
                    if not dq or self._peek_throttled(tname, dq[0],
                                                      now):
                        continue
                    for r in dq:
                        dl = r.meta.deadline_s
                        key = ((0, req_deadline(r), r.t_submit)
                               if dl is not None
                               else (1, 0.0, r.t_submit))
                        entries.append((key, r))
                entries.sort(key=lambda kr: kr[0])
                out.extend(r for _, r in entries)
            else:
                tnames = sorted(
                    (t for t, dq in self._q[lane].items() if dq),
                    key=lambda t: self._tenants[t].vtime)
                for tname in tnames:
                    dq = self._q[lane][tname]
                    if self._peek_throttled(tname, dq[0], now):
                        continue
                    out.extend(dq)
        return out[:n]

    def _peek_throttled(self, tname, head, now):
        """`_lane_head`'s eligibility test, side-effect-free (no
        throttle counters; the bucket refill is idempotent)."""
        ts = self._tenants[tname]
        return (ts.bucket is not None
                and not getattr(head, "_fd_charged", False)
                and not ts.bucket.affords(head.meta.cost, now))

    def pop(self, req, now):
        """Remove an admitted request from its queue; charge its
        tenant's rate bucket (once per request lifetime) and advance
        the tenant's stride clock and the lane service counter."""
        meta = req.meta
        ts = self.tenant(meta.tenant)
        self._q[meta.lane][meta.tenant].remove(req)
        ts.queued -= 1
        self._depth -= 1
        if ts.bucket is not None and not getattr(req, "_fd_charged",
                                                 False):
            ts.bucket.charge(meta.cost, now)
        req._fd_charged = True
        ts.vtime += meta.cost / ts.cfg.weight
        self._served[meta.lane] += 1.0
        self._push_gauges(meta.lane, meta.tenant)

    # ---- preemption policy ----------------------------------------------
    def victims(self, req, occupied, now):
        """Slots the engine may evict to admit `req`: only an
        interactive candidate preempts, and only batch-lane residents
        are victims — newest first (least sunk work; with the prefix
        cache on, even that work is preserved through the swap-out
        publish). `occupied`: list of (slot_idx, resident_request,
        remaining_tokens).

        Drain-wait hysteresis: when ANY resident is within
        `preempt_wait_tokens` of its budget, its slot frees in a few
        rounds anyway — preempting a victim would buy almost nothing
        and cost a swap-out/resume cycle, so the candidate waits (a
        few tokens' worth of TTFT, traded against batch-lane churn).
        A candidate whose deadline has already PASSED preempts
        regardless — lateness beats churn."""
        if not self.preemption or req.meta.lane != "interactive":
            return []
        if self.preempt_wait_tokens > 0 \
                and any(rem <= self.preempt_wait_tokens
                        for _, _, rem in occupied):
            dl = req.meta.deadline_s
            if dl is None or now < req.t_submit + dl:
                return []
        cands = [(j, r) for j, r, _ in occupied
                 if r.meta is not None and r.meta.lane == "batch"]
        # spread the damage: fewest-preempted first (re-hitting the
        # same victim concentrates ALL the eviction delay on one
        # request and stretches the batch lane's completion tail),
        # newest-first among ties (least sunk work)
        cands.sort(key=lambda jr: (getattr(jr[1], "preempts", 0),
                                   -jr[1].t_submit))
        return [j for j, _ in cands]

    # ---- prefill chunk sharing ------------------------------------------
    def prefill_plan(self, entries, budget):
        """Order the feeding slots for one packed prefill chunk and
        cap the interactive lane's total draw at
        `interactive_chunk_share` of the budget when batch prompts are
        feeding too. `entries`: list of (slot_idx, slot_dict).
        Returns [(slot_idx, token_cap_or_None), ...] in feed order."""
        inter, batch = [], []
        for i, s in entries:
            meta = s["req"].meta
            lane = meta.lane if meta is not None else "interactive"
            (inter if lane == "interactive" else batch).append((i, s))

        def edf(item):
            meta = item[1]["req"].meta
            dl = meta.deadline_s if meta is not None else None
            return ((0, dl) if dl is not None else (1, 0.0),
                    item[1]["req"].t_submit)

        inter.sort(key=edf)
        batch.sort(key=lambda item: item[1]["req"].t_submit)
        if not inter or not batch:
            return [(i, None) for i, _ in inter + batch]
        out = []
        rem = int(-(-budget * self.interactive_chunk_share // 1))
        for i, s in inter:
            need = int(s["prompt"].size - s["fed"])
            take = min(need, rem)
            out.append((i, take))
            rem -= take
        out.extend((i, None) for i, _ in batch)
        return out

    # ---- introspection ---------------------------------------------------
    def depth(self):
        return self._depth

    def lane_depths(self):
        return {ln: sum(len(dq) for dq in self._q[ln].values())
                for ln in LANES}

    def tenant_depths(self):
        return {name: ts.queued for name, ts in
                sorted(self._tenants.items())}

    def window_stats(self):
        """Window counters merged into stats()["frontdoor"]; reset via
        reset_window() (the engine's reset_stats calls it)."""
        return {"rejected": self._rejected,
                "rate_throttled_skips": self._throttled}

    def reset_window(self):
        self._rejected = 0
        self._throttled = 0

    def expire(self, now, pred):
        """Remove and return every queued request for which
        `pred(req)` is true — the engine's per-request timeout scan.
        Rate charges are not refunded (the request consumed its
        admission slot); stride clocks are untouched (it never ran)."""
        out = []
        for lane in LANES:
            for tname, dq in self._q[lane].items():
                hits = [r for r in dq if pred(r)]
                for r in hits:
                    dq.remove(r)
                    self._tenants[tname].queued -= 1
                    self._depth -= 1
                    out.append(r)
                if hits:
                    self._push_gauges(lane, tname)
        return out

    def drain(self):
        """Remove and return every queued request (server stop)."""
        out = []
        for lane in LANES:
            for tname, dq in self._q[lane].items():
                out.extend(dq)
                dq.clear()
                self._push_gauges(lane, tname)
        for ts in self._tenants.values():
            ts.queued = 0
        self._depth = 0
        return out

    def _push_gauges(self, lane, tenant):
        if not _metrics.enabled():
            return
        _m_lane_queue.labels(lane=lane).set(
            sum(len(dq) for dq in self._q[lane].values()))
        _m_tenant_queue.labels(tenant=tenant).set(
            self._tenants[tenant].queued)


def req_deadline(req):
    """Absolute deadline of a request (submit time + relative TTFT
    deadline); requests without one sort last via the caller's key."""
    return req.t_submit + req.meta.deadline_s
