"""Live ops endpoint — /metrics, /statusz, /healthz: the port's copy
of `paddle_tpu.observability.exporter`.

A stdlib-only `http.server` daemon thread that makes a running engine
watchable from outside the process:

  * `/metrics`  — Prometheus text exposition from the metrics registry
    (the standard scrape target);
  * `/statusz`  — live JSON engine state from a provider callable
    (the paged server wires `PagedGenerationServer.statusz()`: slots,
    lanes, tenants, pool / prefix-cache / quantization / sharding /
    speculation blocks from `stats()`, flight-recorder and compile
    summaries);
  * `/healthz`  — ok | degraded | stalled from a provider callable;
    ok and degraded answer 200 (the process still serves), stalled
    answers 503 so load balancers drain it. (Legacy shape, kept
    backward-compatible.)
  * `/healthz/live` and `/healthz/ready` — the SPLIT health semantics
    the fleet router routes on: liveness = the engine
    loop is alive (dead -> 503 -> fail over, re-admit its sessions
    elsewhere); readiness = alive AND accepting admissions (a
    draining or stalled engine answers 503 ready=false -> stop
    routing NEW sessions there, but do NOT fail over the residents).
    Both return {"live"/"ready": bool, ...detail}.
  * `/slo`      — the burn-rate report of the attached SLO engine
    (`observability.slo`): per-SLO state ok | warn | page with fast and
    slow burn rates and error-budget accounting; a paging report
    answers 503. Served only when the owner wired an SLO engine (the
    paged server's `slos=`), else 404.
  * `/capacity` — the versioned `PressureSignals` snapshot: pool
    headroom and exhaustion forecast, tier occupancy, queue depths,
    shed and exhaustion pressure and SLO burn states. Served only when
    the owner wired a provider (the paged server always does).

Binding is ephemeral-port friendly (`port=0` → the kernel picks; the
bound port is on `.port`/`.url` after `start()` returns), which is how
the tests and `PagedGenerationServer(expose_port=0)` use it. Loopback
by default — exposing telemetry beyond the host is a deployment
decision, not a library default.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import log as _log
from . import metrics as _metrics

_logger = _log.get_logger(__name__)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
HEALTH_STATES = ("ok", "degraded", "stalled")

_m_scrapes = _metrics.counter(
    "serving_ops_scrapes_total",
    "ops-endpoint requests served, by endpoint "
    "(metrics | statusz | healthz | livez | readyz | slo | capacity)",
    labelnames=("endpoint",))


class OpsEndpoint:
    """One HTTP listener serving the scrape/status/health triad.

    registry: a metrics.Registry (default: the process registry).
    statusz_fn: zero-arg callable returning a JSON-serializable dict.
    healthz_fn: zero-arg callable returning either a status string or
        a (status, detail_dict) pair; status must be one of
        ok | degraded | stalled.
    livez_fn / readyz_fn: zero-arg callables returning (bool, detail)
        for the split /healthz/live and /healthz/ready endpoints
        (absent -> those paths answer 404, the pre-split shape).
    metrics_fn: zero-arg callable returning Prometheus text to serve
        at /metrics INSTEAD of the registry (the fleet router's
        federated, replica-labeled view).
    slo_fn: zero-arg callable returning the SLO burn-rate report dict
        (`observability.slo.SLOEngine.report()` shape: {"slos": [...],
        "worst": ok|warn|page, "paging": [...]}) served at /slo —
        answers 200 while worst is ok or warn, 503 on page (the
        load-balancer drain signal); absent -> /slo answers 404.
    capacity_fn: zero-arg callable returning the versioned capacity
        snapshot (`observability.capacity.PressureSignals.sample()`
        shape, or the fleet-federated twin) served at /capacity;
        absent -> /capacity answers 404.
    """

    def __init__(self, registry=None, statusz_fn=None, healthz_fn=None,
                 livez_fn=None, readyz_fn=None, metrics_fn=None,
                 slo_fn=None, capacity_fn=None):
        self._registry = registry or _metrics.REGISTRY
        self._statusz_fn = statusz_fn
        self._healthz_fn = healthz_fn
        self._livez_fn = livez_fn
        self._readyz_fn = readyz_fn
        self._metrics_fn = metrics_fn
        self._slo_fn = slo_fn
        self._capacity_fn = capacity_fn
        self._httpd = None
        self._thread = None
        self.port = None

    @property
    def url(self):
        return None if self.port is None else f"http://127.0.0.1:{self.port}"

    # -- lifecycle --------------------------------------------------------
    def start(self, port=0, host="127.0.0.1"):
        if self._httpd is not None:
            return self
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stderr per request
                _logger.debug("ops endpoint: " + fmt, *args)

            def _send(self, code, body, ctype):
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        _m_scrapes.labels(endpoint="metrics").inc()
                        body = (endpoint._metrics_fn()
                                if endpoint._metrics_fn
                                else endpoint._registry.to_prometheus())
                        self._send(200, body, PROM_CONTENT_TYPE)
                    elif path == "/healthz/live" \
                            and endpoint._livez_fn is not None:
                        _m_scrapes.labels(endpoint="livez").inc()
                        ok, detail = endpoint._livez_fn()
                        self._send(200 if ok else 503, json.dumps(
                            {"live": bool(ok), **dict(detail)}),
                            "application/json")
                    elif path == "/healthz/ready" \
                            and endpoint._readyz_fn is not None:
                        _m_scrapes.labels(endpoint="readyz").inc()
                        ok, detail = endpoint._readyz_fn()
                        self._send(200 if ok else 503, json.dumps(
                            {"ready": bool(ok), **dict(detail)}),
                            "application/json")
                    elif path == "/statusz":
                        _m_scrapes.labels(endpoint="statusz").inc()
                        body = (endpoint._statusz_fn()
                                if endpoint._statusz_fn else {})
                        self._send(200, json.dumps(body, default=str),
                                   "application/json")
                    elif path == "/healthz":
                        _m_scrapes.labels(endpoint="healthz").inc()
                        status, detail = endpoint._health()
                        self._send(
                            503 if status == "stalled" else 200,
                            json.dumps({"status": status, **detail}),
                            "application/json")
                    elif path == "/slo" \
                            and endpoint._slo_fn is not None:
                        _m_scrapes.labels(endpoint="slo").inc()
                        report = endpoint._slo_fn()
                        code = (503 if report.get("worst") == "page"
                                else 200)
                        self._send(code, json.dumps(report),
                                   "application/json")
                    elif path == "/capacity" \
                            and endpoint._capacity_fn is not None:
                        _m_scrapes.labels(endpoint="capacity").inc()
                        snap = endpoint._capacity_fn()
                        self._send(200, json.dumps(snap, default=str),
                                   "application/json")
                    else:
                        paths = ["/metrics", "/statusz", "/healthz"]
                        if endpoint._livez_fn is not None:
                            paths.append("/healthz/live")
                        if endpoint._readyz_fn is not None:
                            paths.append("/healthz/ready")
                        if endpoint._slo_fn is not None:
                            paths.append("/slo")
                        if endpoint._capacity_fn is not None:
                            paths.append("/capacity")
                        self._send(404, json.dumps(
                            {"error": f"unknown path {path!r}",
                             "paths": paths}),
                            "application/json")
                except Exception as e:  # noqa: BLE001 — a provider bug
                    # must answer 500, not kill the listener thread
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}),
                        "application/json")

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"paddle-tpu-ops-endpoint:{self.port}")
        self._thread.start()
        _logger.info("ops endpoint serving /metrics /statusz /healthz "
                     "on %s", self.url)
        return self

    def _health(self):
        if self._healthz_fn is None:
            return "ok", {}
        out = self._healthz_fn()
        if isinstance(out, str):
            status, detail = out, {}
        else:
            status, detail = out
        if status not in HEALTH_STATES:
            return "degraded", {"detail": f"bad health state {status!r}"}
        return status, dict(detail)

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        self.port = None
