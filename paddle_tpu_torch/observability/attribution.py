"""Per-tenant / per-request resource attribution: the port's copy of
`paddle_tpu.observability.attribution`.

The serving stack already *measures* everything that costs money —
device-busy wall time, KV pool occupancy, host-tier bytes, collective
wire bytes, compile time — but none of it says WHO spent it. This
module is the cost ledger the engine, pool and tier charge into, built
around one rule: **exact conservation**. Every charged quantity is an
integer (nanoseconds or bytes) split with largest-remainder
apportionment, so

  * Σ over tenants of device-ns     == engine busy-ns, exactly;
  * Σ over tenants of KV block-ns   == the pool occupancy integral
    (blocks × time, integrated on the same event clock), exactly;
  * Σ over tenants of host byte-ns  == the host-tier occupancy
    integral, exactly;
  * Σ over tenants of wire bytes    == the analytic collective
    counters + migration payload bytes, exactly (0 on one unsharded
    engine: the port's servers move no wire bytes yet).

There is no "unattributed" bucket and no float residue — conservation
is arithmetic, not approximation, which is what makes the ledger a
billing surface (`CostReport.to_json()`) rather than a sampling one.

Block-seconds use a single-owner model: each non-free pool block is
owned by exactly one (tenant, request) — the one whose `_take_blocks`
pulled it off the free list — until the block RETURNS to the free
list. Prefix sharing, retention and revival keep the original owner
(the publisher pays; the attacher is credited `prefix_saved_*`
instead), so per-tenant block counts always sum to pool occupancy no
matter how wild the sharing graph gets.

Everything takes an explicit clock (`clock_ns=`, default
`time.monotonic_ns`) so conservation properties are replay-testable
on a fake clock, same discipline as `utils.net.TokenBucket`.
"""
from __future__ import annotations

import json
import threading
import time

from . import metrics as _metrics

_NS = 1_000_000_000

_m_tenant_device = _metrics.counter(
    "serving_tenant_device_seconds_total",
    "device-busy seconds apportioned to the tenant's resident requests "
    "per dispatch (exact: sums to engine busy time)",
    labelnames=("tenant",))
_m_tenant_block = _metrics.counter(
    "serving_tenant_kv_block_seconds_total",
    "KV device-block-seconds owned by the tenant (exact: sums to the "
    "pool occupancy integral)", labelnames=("tenant",))
_m_tenant_host = _metrics.counter(
    "serving_tenant_host_byte_seconds_total",
    "host-tier byte-seconds owned by the tenant's demoted KV entries",
    labelnames=("tenant",))
_m_tenant_wire = _metrics.counter(
    "serving_tenant_wire_bytes_total",
    "wire bytes attributed to the tenant by kind (collective = "
    "analytic sharded-decode bytes, migration = session export payloads)",
    labelnames=("tenant", "kind"))
_m_tenant_compile = _metrics.counter(
    "serving_tenant_compile_seconds_total",
    "compile (CUDA graph capture) seconds charged to the tenant whose dispatch triggered "
    "the compile", labelnames=("tenant",))
_m_tenant_prefix_saved = _metrics.counter(
    "serving_tenant_prefix_saved_tokens_total",
    "prompt tokens the tenant attached from the prefix cache instead of "
    "prefilling", labelnames=("tenant",))
_m_tenant_requests = _metrics.counter(
    "serving_tenant_requests_total",
    "requests finished per tenant (any terminal reason)",
    labelnames=("tenant",))


def apportion(total, weights):
    """Split integer `total` by integer `weights`, conserving exactly.

    Largest-remainder division in pure integer arithmetic: shares are
    `total*w // Σw` plus one extra unit to the largest remainders
    (ties broken by index, so the split is deterministic). Guarantees
    `sum(apportion(t, w)) == t` for any non-negative weights; an
    all-zero weight vector degrades to an even split.
    """
    n = len(weights)
    if n == 0:
        return []
    total = int(total)
    ws = [max(0, int(w)) for w in weights]
    wsum = sum(ws)
    if wsum == 0:
        ws = [1] * n
        wsum = n
    shares = [total * w // wsum for w in ws]
    left = total - sum(shares)
    rems = [(total * w) % wsum for w in ws]
    for i in sorted(range(n), key=lambda i: (-rems[i], i))[:left]:
        shares[i] += 1
    return shares


def _tenant_zero():
    return {"device_ns": 0, "compile_ns": 0, "block_ns": 0,
            "host_byte_ns": 0, "wire_bytes": 0, "wire_migration_bytes": 0,
            "prefix_saved_tokens": 0, "prefix_saved_ns": 0,
            "requests": 0, "new_tokens": 0}


class CostReport:
    """Frozen view of a ledger window — the billing export."""

    def __init__(self, payload):
        self._payload = payload

    def __getitem__(self, k):
        return self._payload[k]

    @property
    def tenants(self):
        return self._payload["tenants"]

    @property
    def totals(self):
        return self._payload["totals"]

    def to_dict(self):
        return self._payload

    def to_json(self, indent=None):
        return json.dumps(self._payload, indent=indent, sort_keys=True)


class ResourceLedger:
    """The attribution ledger: integer-exact per-tenant cost accounts.

    Thread-safe; every mutator takes the one lock. The engine charges
    device/compile/wire, the pool reports block ownership transitions
    (free-list boundary crossings only), and the tier reports host-byte
    ownership. `stats()` is the live window; `reset()` zeroes the
    window but carries the CURRENT occupancy levels forward so the
    next window's integrals start from zero coherently.
    """

    def __init__(self, clock_ns=None):
        self._clock = clock_ns or time.monotonic_ns
        self._lock = threading.RLock()
        self._tenants = {}          # tenant -> account dict
        self._reqs = {}             # live rid -> per-request account
        # block / host-byte ownership LEVELS (survive reset())
        self._blk = {}              # tenant -> owned device blocks
        self._rid_blk = {}          # live rid -> owned device blocks
        self._host = {}             # tenant -> owned host-tier bytes
        self._last_ns = self._clock()
        # window totals (the conservation right-hand sides)
        self._busy_ns = 0
        self._occ_block_ns = 0
        self._host_occ_byte_ns = 0
        self._wire_bytes = 0
        self._compile_ns = 0
        # measured per-token prefill cost (EMA, ns/token) for
        # prefix-savings credit
        self._prefill_ns_per_tok = 0.0
        self._prefill_samples = 0

    # -- internals ----------------------------------------------------

    def _acct(self, tenant):
        a = self._tenants.get(tenant)
        if a is None:
            a = self._tenants[tenant] = _tenant_zero()
        return a

    def _advance(self, now_ns):
        """Integrate occupancy up to `now_ns`.

        Per-tenant block-ns and the pool occupancy integral advance by
        the SAME `count * dt` products, so Σ tenants == occupancy by
        distributivity — conservation is maintained at every event,
        not reconciled after the fact.
        """
        dt = now_ns - self._last_ns
        if dt <= 0:
            self._last_ns = max(self._last_ns, now_ns)
            return
        self._last_ns = now_ns
        for t, c in self._blk.items():
            if c:
                add = c * dt
                self._acct(t)["block_ns"] += add
                if _metrics.enabled():
                    _m_tenant_block.labels(tenant=t).inc(add / _NS)
        self._occ_block_ns += sum(self._blk.values()) * dt
        for rid, c in self._rid_blk.items():
            if c:
                r = self._reqs.get(rid)
                if r is not None:
                    r["block_ns"] += c * dt
        for t, b in self._host.items():
            if b:
                add = b * dt
                self._acct(t)["host_byte_ns"] += add
                if _metrics.enabled():
                    _m_tenant_host.labels(tenant=t).inc(add / _NS)
        self._host_occ_byte_ns += sum(self._host.values()) * dt

    # -- pool / tier event surface ------------------------------------

    def block_event(self, tenant, rid, delta, now_ns=None):
        """A block crossed the free-list boundary (+1 taken, -1 freed)."""
        with self._lock:
            self._advance(self._clock() if now_ns is None else now_ns)
            self._blk[tenant] = self._blk.get(tenant, 0) + delta
            if self._blk[tenant] <= 0:
                del self._blk[tenant]
            if rid is not None and rid in self._reqs:
                c = self._rid_blk.get(rid, 0) + delta
                if c > 0:
                    self._rid_blk[rid] = c
                else:
                    self._rid_blk.pop(rid, None)

    def host_bytes_event(self, tenant, delta_bytes, now_ns=None):
        """Host-tier bytes entered (+) or left (-) the tenant's account."""
        with self._lock:
            self._advance(self._clock() if now_ns is None else now_ns)
            self._host[tenant] = self._host.get(tenant, 0) + delta_bytes
            if self._host[tenant] <= 0:
                del self._host[tenant]

    def owned_blocks(self):
        """Current per-tenant device-block ownership (test surface)."""
        with self._lock:
            return dict(self._blk)

    def owned_host_bytes(self):
        with self._lock:
            return dict(self._host)

    # -- engine charge surface ----------------------------------------

    def charge_device(self, dur_ns, parts):
        """Apportion `dur_ns` of device-busy time over `parts`.

        `parts` is a list of (tenant, rid, weight) — one entry per
        resident request the dispatch computed for, weighted by its
        token count in the round. One apportion call produces BOTH the
        per-tenant and per-request shares, so they agree exactly.
        """
        if dur_ns <= 0 or not parts:
            return
        with self._lock:
            shares = apportion(int(dur_ns), [p[2] for p in parts])
            self._busy_ns += int(dur_ns)
            for (tenant, rid, _w), s in zip(parts, shares):
                self._acct(tenant)["device_ns"] += s
                r = self._reqs.get(rid)
                if r is not None:
                    r["device_ns"] += s
                if s and _metrics.enabled():
                    _m_tenant_device.labels(tenant=tenant).inc(s / _NS)

    def charge_compile(self, dur_ns, parts):
        """Charge an in-window compile to the dispatch that tripped it."""
        if dur_ns <= 0 or not parts:
            return
        with self._lock:
            shares = apportion(int(dur_ns), [p[2] for p in parts])
            self._compile_ns += int(dur_ns)
            for (tenant, rid, _w), s in zip(parts, shares):
                self._acct(tenant)["compile_ns"] += s
                r = self._reqs.get(rid)
                if r is not None:
                    r["compile_ns"] += s
                if s and _metrics.enabled():
                    _m_tenant_compile.labels(tenant=tenant).inc(s / _NS)

    def charge_wire(self, nbytes, parts, kind="collective"):
        """Apportion wire bytes (collective traffic or migration payload)."""
        if nbytes <= 0 or not parts:
            return
        key = ("wire_migration_bytes" if kind == "migration"
               else "wire_bytes")
        with self._lock:
            shares = apportion(int(nbytes), [p[2] for p in parts])
            self._wire_bytes += int(nbytes)
            for (tenant, rid, _w), s in zip(parts, shares):
                self._acct(tenant)[key] += s
                r = self._reqs.get(rid)
                if r is not None:
                    r[key] += s
                if s and _metrics.enabled():
                    _m_tenant_wire.labels(tenant=tenant, kind=kind).inc(s)

    def note_prefill_cost(self, dur_ns, tokens):
        """Feed one measured prefill dispatch (EMA of ns per token)."""
        if tokens <= 0 or dur_ns <= 0:
            return
        with self._lock:
            per = dur_ns / tokens
            if self._prefill_samples == 0:
                self._prefill_ns_per_tok = per
            else:
                self._prefill_ns_per_tok += 0.2 * (
                    per - self._prefill_ns_per_tok)
            self._prefill_samples += 1

    def prefill_cost_ns_per_token(self):
        with self._lock:
            return self._prefill_ns_per_tok

    def credit_prefix(self, tenant, rid, tokens):
        """Credit a prefix-cache attach: tokens NOT prefilled, valued at
        the measured per-token prefill cost."""
        if tokens <= 0:
            return
        with self._lock:
            saved_ns = int(tokens * self._prefill_ns_per_tok)
            a = self._acct(tenant)
            a["prefix_saved_tokens"] += tokens
            a["prefix_saved_ns"] += saved_ns
            r = self._reqs.get(rid)
            if r is not None:
                r["prefix_saved_tokens"] += tokens
                r["prefix_saved_ns"] += saved_ns
            if _metrics.enabled():
                _m_tenant_prefix_saved.labels(tenant=tenant).inc(tokens)

    # -- request lifecycle --------------------------------------------

    def request_begin(self, rid, tenant):
        with self._lock:
            self._reqs[rid] = {
                "tenant": tenant, "device_ns": 0, "compile_ns": 0,
                "block_ns": 0, "wire_bytes": 0, "wire_migration_bytes": 0,
                "prefix_saved_tokens": 0, "prefix_saved_ns": 0}

    def request_done(self, rid, new_tokens=0):
        """Close a request's account; returns its cost dict (or None if
        unknown/already closed — idempotent by design, the engine has
        several terminal paths)."""
        with self._lock:
            self._advance(self._clock())
            r = self._reqs.pop(rid, None)
            if r is None:
                return None
            # residual blocks stay owned by the tenant (retained prefix
            # state outlives the request); only the per-rid live view ends
            self._rid_blk.pop(rid, None)
            a = self._acct(r["tenant"])
            a["requests"] += 1
            a["new_tokens"] += int(new_tokens)
            if _metrics.enabled():
                _m_tenant_requests.labels(tenant=r["tenant"]).inc()
            cost = {k: v for k, v in r.items() if k != "tenant"}
            cost["tenant"] = r["tenant"]
            cost["device_ms"] = round(r["device_ns"] / 1e6, 3)
            cost["kv_block_s"] = round(r["block_ns"] / _NS, 6)
            return cost

    # -- reporting ----------------------------------------------------

    def _stats_locked(self):
        self._advance(self._clock())
        tenants = {}
        for t, a in sorted(self._tenants.items()):
            tenants[t] = {
                "device_s": round(a["device_ns"] / _NS, 6),
                "device_ns": a["device_ns"],
                "kv_block_s": round(a["block_ns"] / _NS, 6),
                "kv_block_ns": a["block_ns"],
                "host_byte_s": round(a["host_byte_ns"] / _NS, 6),
                "host_byte_ns": a["host_byte_ns"],
                "wire_bytes": a["wire_bytes"],
                "wire_migration_bytes": a["wire_migration_bytes"],
                "compile_s": round(a["compile_ns"] / _NS, 6),
                "compile_ns": a["compile_ns"],
                "prefix_saved_tokens": a["prefix_saved_tokens"],
                "prefix_saved_s": round(a["prefix_saved_ns"] / _NS, 6),
                "requests": a["requests"],
                "new_tokens": a["new_tokens"],
            }
        dev_sum = sum(a["device_ns"] for a in self._tenants.values())
        blk_sum = sum(a["block_ns"] for a in self._tenants.values())
        host_sum = sum(a["host_byte_ns"] for a in self._tenants.values())
        wire_sum = sum(a["wire_bytes"] + a["wire_migration_bytes"]
                       for a in self._tenants.values())
        comp_sum = sum(a["compile_ns"] for a in self._tenants.values())
        return {
            "enabled": True,
            "tenants": tenants,
            "totals": {
                "busy_ns": self._busy_ns,
                "busy_s": round(self._busy_ns / _NS, 6),
                "occupancy_block_ns": self._occ_block_ns,
                "host_occupancy_byte_ns": self._host_occ_byte_ns,
                "wire_bytes": self._wire_bytes,
                "compile_ns": self._compile_ns,
                "prefill_cost_ns_per_token": round(
                    self._prefill_ns_per_tok, 1),
            },
            "conservation": {
                "device_residual_ns": self._busy_ns - dev_sum,
                "block_residual_ns": self._occ_block_ns - blk_sum,
                "host_residual_byte_ns": (
                    self._host_occ_byte_ns - host_sum),
                "wire_residual_bytes": self._wire_bytes - wire_sum,
                "compile_residual_ns": self._compile_ns - comp_sum,
            },
        }

    def stats(self):
        with self._lock:
            return self._stats_locked()

    def report(self):
        """Billing export for the current window."""
        with self._lock:
            payload = self._stats_locked()
            payload["schema_version"] = 1
            return CostReport(payload)

    def reset(self):
        """Zero the window accounts. Occupancy LEVELS (current block /
        host-byte ownership) carry forward so the next window's
        integrals restart from zero on both sides of the conservation
        equation — reset-coherent."""
        with self._lock:
            self._advance(self._clock())
            self._tenants.clear()
            self._reqs.clear()
            self._rid_blk.clear()
            self._busy_ns = 0
            self._occ_block_ns = 0
            self._host_occ_byte_ns = 0
            self._wire_bytes = 0
            self._compile_ns = 0


def disabled_attribution_stats():
    """The `stats()["attribution"]` block when attribution is off —
    schema-congruent with the enabled block, all zeros (the
    `disabled_tier_stats` convention)."""
    return {
        "enabled": False,
        "tenants": {},
        "totals": {"busy_ns": 0, "busy_s": 0.0, "occupancy_block_ns": 0,
                   "host_occupancy_byte_ns": 0, "wire_bytes": 0,
                   "compile_ns": 0, "prefill_cost_ns_per_token": 0.0},
        "conservation": {"device_residual_ns": 0, "block_residual_ns": 0,
                         "host_residual_byte_ns": 0,
                         "wire_residual_bytes": 0,
                         "compile_residual_ns": 0},
    }
