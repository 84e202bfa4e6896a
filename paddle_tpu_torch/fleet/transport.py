"""Wire transport: subprocess replicas behind stdlib HTTP; the port's
copy of `paddle_tpu.fleet.transport`, with the same paths, status
codes, token lines and handshake, so either package's client speaks to
either package's worker.

The in-process fleet holds every replica in ONE process; this module cuts the replica boundary at a real wire so the
scaling numbers become real. The wire surface is deliberately the
surface the router already speaks:

  * admission  — `POST /submit` carries either a FRESH request (the
    router-resolved sampling/seed/meta/trace, exactly `submit()`'s
    arguments) or a journal-shape resume entry (the
    `SessionJournal.entry_for` dict `admit_journal_entry` consumes).
    The response is a newline-delimited JSON token stream — one
    `{"tok", "reason"}` line per generated token, then one terminal
    `{"result"}` or typed `{"error"}` line — so the router's
    journaling token callback fires exactly as it does in-process.
  * KV migration — `POST /export` ships the journal entry plus the
    session's published K/V as the compressed wire bytes
    (`serialize_kv_payload`: int8 codes + scales); `POST /import`
    accepts the same bytes. Int8 KV pools ship bit-exactly, so a
    subprocess migration is byte-for-byte the in-process one.
  * probes — `/healthz/live`, `/healthz/ready`, `/load`,
    `/match_prefix`, `/capacity`, `/stats`, `/metrics`, `/events`
    mirror the `Replica` probe surface 1:1.

`RemoteReplica` adapts that wire back into the replica protocol, so
FleetRouter's journal/failover/migration logic runs UNCHANGED over OS
processes: a dead subprocess fails its streams and probes, and the
ordinary failover re-admits its sessions token-identically from
the router journal.

Error mapping across the wire (the contract `_on_replica_done`
relies on): `AdmissionShed` -> HTTP 429 and re-raised typed (the
router retries another replica); eager validation errors -> HTTP 400
(`ValueError`/`TypeError`); per-request terminal failures
(`QuarantinedRequest`, `RequestTimeout`) ride the stream's terminal
line and are reconstructed typed (no failover — same as in-process);
any transport failure (connect refused, stream cut mid-request)
surfaces as `ReplicaUnavailable` on the future, which the router
treats as a replica failure and fails over.

Workers run `python -m paddle_tpu_torch.fleet.transport --config
<json>` and import neither JAX nor the JAX package. The config builds
the model one of two ways (`build_worker_server`): the port's own
seeded init (an explicit `torch.Generator`), or reference-layout
parameters from an npz file through `from_reference_params` — the
reference rebuilds its model from `paddle.seed`, whose initialiser the
port cannot reproduce, so a worker held to the reference loads its
weights. The worker runs on the card unless the config says
`"device": "cpu"`; it never falls back to the CPU.
"""
from __future__ import annotations

import http.client
import json
import os
import queue
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..observability import log as _obs_log
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..reliability.errors import (AdmissionShed, QuarantinedRequest,
                                  ReplicaUnavailable, RequestTimeout)
from .migration import deserialize_kv_payload, serialize_kv_payload
from .replica import Replica

_logger = _obs_log.get_logger(__name__)

_m_wire_requests = _metrics.counter(
    "fleet_wire_requests_total",
    "Wire transport calls by verb (router side)", labelnames=("verb",))
_m_wire_tokens = _metrics.counter(
    "fleet_wire_tokens_total",
    "Tokens streamed over the wire transport (router side)")
_m_wire_bytes = _metrics.counter(
    "fleet_wire_bytes_total",
    "Wire transport payload bytes (router side)",
    labelnames=("direction",))
_m_wire_errors = _metrics.counter(
    "fleet_wire_errors_total",
    "Wire transport failures by kind (router side)", labelnames=("kind",))

#: handshake line a worker prints on stdout once its engine and HTTP
#: server are up — the parent parses `port=`/`pid=` from it.
HANDSHAKE_PREFIX = "PADDLE_TPU_WORKER"

#: worker-side stall guard: if the engine emits nothing on a stream
#: for this long the worker ends it with an error line (the client
#: maps that to ReplicaUnavailable -> router failover).
STREAM_IDLE_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# wire encoding helpers (shared by both ends)
# ---------------------------------------------------------------------------

def _sampling_to_wire(sampling):
    from dataclasses import asdict, is_dataclass

    if sampling is None:
        return None
    if is_dataclass(sampling):
        return asdict(sampling)
    raise TypeError(f"sampling must be a SamplingParams, "
                    f"got {type(sampling).__name__}")


def _meta_to_wire(meta):
    if meta is None:
        return None
    return {"lane": meta.lane, "tenant": meta.tenant,
            "deadline_s": meta.deadline_s, "cost": meta.cost}


def _exc_to_wire(exc):
    if isinstance(exc, QuarantinedRequest):
        return {"type": "QuarantinedRequest", "rid": exc.rid,
                "seam": exc.seam, "failures": exc.failures,
                "cause": f"{type(exc.cause).__name__}: {exc.cause}"}
    if isinstance(exc, RequestTimeout):
        return {"type": "RequestTimeout", "rid": exc.rid,
                "waited_s": exc.waited_s, "timeout_s": exc.timeout_s}
    return {"type": type(exc).__name__, "msg": str(exc)}


def _exc_from_wire(err, rid):
    t = err.get("type", "RuntimeError")
    if t == "QuarantinedRequest":
        return QuarantinedRequest(err.get("rid", rid), err.get("seam", "?"),
                                  int(err.get("failures", 1)),
                                  RuntimeError(err.get("cause", "")))
    if t == "RequestTimeout":
        return RequestTimeout(err.get("rid", rid),
                              float(err.get("waited_s", 0.0)),
                              float(err.get("timeout_s", 0.0)))
    return RuntimeError(f"remote {t}: {err.get('msg', '')}")


def _jsonable(obj):
    """Best-effort JSON coercion for stats/capacity payloads (numpy
    scalars and arrays appear in engine stats)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


# ---------------------------------------------------------------------------
# worker side (runs in the subprocess)
# ---------------------------------------------------------------------------

def build_worker_server(config):
    """Build the model and construct the engine.

    config["model"]: {"kind": "gpt2", "config": {GPT2Config kwargs},
        "dtype": "float32" | "bfloat16" (default float32)} plus either
        "seed": int — the port's seeded init (`GPT2(cfg, seed=...)`) —
        or "weights": an npz path of reference-layout parameters (a
        `functional_state()` as numpy), loaded through
        `from_reference_params`.
    config["device"]: "cpu" runs the plain PyTorch path on the CPU;
        anything else (or nothing) is the card, and a host without one
        raises (`resolve_device`).
    config["server"]: JSON-able `PagedGenerationServer` kwargs;
        "kv_tier" (dict) becomes a `HostKVTier`, "journal" (path str)
        a `SessionJournal`, "speculation" passes through (True or a
        SpecConfig dict).
    """
    import torch

    from ..inference.serving import PagedGenerationServer
    from ..models.gpt2 import GPT2, GPT2Config, from_reference_params

    spec = config.get("model", {})
    kind = spec.get("kind", "gpt2")
    if kind != "gpt2":
        raise ValueError(f"unknown worker model kind {kind!r}")
    device = "cpu" if config.get("device") == "cpu" else None
    dtype = getattr(torch, spec.get("dtype", "float32"))
    cfg = GPT2Config(**spec.get("config", {}))
    if spec.get("weights") is not None:
        with np.load(spec["weights"]) as z:
            params = {k: z[k] for k in z.files}
        model = from_reference_params(cfg, params, device=device)
        if dtype != torch.float32:
            model = model.to(dtype)
    else:
        model = GPT2(cfg, seed=int(spec.get("seed", 0)), dtype=dtype,
                     device=device)

    kw = dict(config.get("server", {}))
    tier = kw.pop("kv_tier", None)
    if tier:
        from ..inference.kv_tier import HostKVTier
        kw["kv_tier"] = HostKVTier(**tier)
    jr = kw.pop("journal", None)
    if jr:
        from ..reliability import SessionJournal
        kw["journal"] = SessionJournal(jr)
    return PagedGenerationServer(model, device=device, **kw)


class _WorkerState:
    """Everything the HTTP handlers touch: the engine plus a local
    `Replica` used purely as the probe-surface delegate (load, queue
    depth, prefix match, capacity — identical arithmetic to the
    in-process replica the router would otherwise wrap)."""

    def __init__(self, name, srv):
        self.name = name
        self.srv = srv
        self.probe = Replica(name, srv)
        self.probe._started = True  # started out-of-band below


class _WorkerHandler(BaseHTTPRequestHandler):
    # HTTP/1.0: every response is close-delimited, so the token
    # stream needs no chunked framing — the client reads lines until
    # EOF. One connection per call is fine at fleet probe rates.
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):  # noqa: D102 — quiet worker
        pass

    # -- plumbing --------------------------------------------------------
    def _state(self):
        return self.server.worker_state

    def _read_body(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(n) if n else b""

    def _send_json(self, code, obj):
        body = json.dumps(_jsonable(obj)).encode()
        self._send_raw(code, body, "application/json")

    def _send_raw(self, code, body, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _write_line(self, obj):
        self.wfile.write(json.dumps(obj).encode() + b"\n")
        self.wfile.flush()

    # -- routes ----------------------------------------------------------
    def do_GET(self):  # noqa: N802 — http.server API
        st = self._state()
        try:
            if self.path == "/info":
                srv = st.srv
                self._send_json(200, {
                    "name": st.name, "pid": os.getpid(),
                    "max_new": srv.max_new, "max_slots": srv.max_slots,
                    "enable_prefix_cache": srv.enable_prefix_cache,
                    "warmed": bool(getattr(srv, "_warm_ran", False))})
            elif self.path == "/healthz/live":
                live, detail = st.probe.liveness()
                self._send_json(200, {"live": bool(live),
                                      "detail": detail})
            elif self.path == "/healthz/ready":
                ready, detail = st.probe.readiness()
                self._send_json(200, {"ready": bool(ready),
                                      "detail": detail})
            elif self.path == "/load":
                self._send_json(200, {
                    "load": st.probe.load(),
                    "queue_depth": st.probe.queue_depth()})
            elif self.path == "/capacity":
                self._send_json(200, st.probe.capacity())
            elif self.path == "/stats":
                from ..ops import kernels

                # this process's K1/K2 launch counts beside the engine's
                # stats: the parent cannot read another process's
                # counters
                self._send_json(200, dict(
                    st.srv.stats(),
                    kernel_launches=kernels.launch_counts()))
            elif self.path == "/metrics":
                # a subprocess replica serves its OWN registry — the
                # parent's federation labels it by replica name
                self._send_raw(200, _metrics.REGISTRY.to_prometheus()
                               .encode(), "text/plain; version=0.0.4")
            elif self.path == "/events":
                try:
                    evs = list(st.srv._recorder.events())
                except Exception:  # noqa: BLE001 — recorder optional
                    evs = []
                self._send_json(200, evs)
            else:
                self._send_json(404, {"msg": f"no route {self.path}"})
        except Exception as e:  # noqa: BLE001 — worker must not die
            try:
                self._send_json(500, {"type": type(e).__name__,
                                      "msg": str(e)})
            except Exception:  # noqa: BLE001 — client already gone
                pass

    def do_POST(self):  # noqa: N802 — http.server API
        try:
            if self.path == "/submit":
                self._do_submit()
            elif self.path == "/export":
                self._do_export()
            elif self.path == "/import":
                self._do_import()
            elif self.path == "/match_prefix":
                body = json.loads(self._read_body() or b"{}")
                n = self._state().probe.prefix_match_len(
                    np.asarray(body.get("ids", []), np.int32))
                self._send_json(200, {"match_len": int(n)})
            elif self.path == "/drain":
                body = json.loads(self._read_body() or b"{}")
                self._state().srv.set_draining(
                    bool(body.get("draining", True)))
                self._send_json(200, {"ok": True})
            elif self.path == "/shutdown":
                self._send_json(200, {"ok": True})
                threading.Thread(target=self.server.initiate_shutdown,
                                 daemon=True).start()
            else:
                self._send_json(404, {"msg": f"no route {self.path}"})
        except Exception as e:  # noqa: BLE001 — worker must not die
            try:
                self._send_json(500, {"type": type(e).__name__,
                                      "msg": str(e)})
            except Exception:  # noqa: BLE001
                pass

    # -- admission + token stream ---------------------------------------
    def _do_submit(self):
        from ..inference.serving import RequestMeta
        from ..observability.trace_context import TraceContext
        from ..sampling import SamplingParams

        body = json.loads(self._read_body())
        srv = self._state().srv
        q = queue.Queue()

        def on_tok(tok, reason):
            q.put(("tok", int(tok),
                   None if reason is None else str(reason)))

        try:
            if body.get("fresh"):
                sampling = None
                if body.get("sampling"):
                    sampling = SamplingParams(
                        **{k: tuple(v) if isinstance(v, list) else v
                           for k, v in body["sampling"].items()})
                meta = None
                if body.get("meta"):
                    m = body["meta"]
                    meta = RequestMeta(
                        lane=m.get("lane", "interactive"),
                        tenant=m.get("tenant", "default"),
                        deadline_s=m.get("deadline_s"),
                        cost=int(m.get("cost", 0)))
                trace_ctx = (TraceContext.from_dict(body["trace"])
                             if body.get("trace") else None)
                fut = srv.submit(
                    np.asarray(body["ids"], np.int32),
                    max_new_tokens=body.get("max_new_tokens"),
                    sampling=sampling, meta=meta, on_token=on_tok,
                    timeout_s=body.get("timeout_s"),
                    rid=body.get("rid"), trace_ctx=trace_ctx)
            else:
                ent = {k: v for k, v in body.items() if k != "fresh"}
                fut = srv.admit_journal_entry(ent, on_token=on_tok)
        except AdmissionShed as e:
            self._send_json(429, {"type": "AdmissionShed",
                                  "depth": e.depth,
                                  "shed_depth": e.shed_depth,
                                  "retry_after_s": e.retry_after_s})
            return
        except (ValueError, TypeError) as e:
            self._send_json(400, {"type": type(e).__name__,
                                  "msg": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — typed to the client
            self._send_json(500, {"type": type(e).__name__,
                                  "msg": str(e)})
            return

        fut.add_done_callback(lambda f: q.put(("done", f)))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            while True:
                try:
                    item = q.get(timeout=STREAM_IDLE_TIMEOUT_S)
                except queue.Empty:
                    self._write_line({"error": {
                        "type": "WireStreamStall",
                        "msg": f"no engine progress in "
                               f"{STREAM_IDLE_TIMEOUT_S:g}s"}})
                    return
                if item[0] == "tok":
                    self._write_line({"tok": item[1],
                                      "reason": item[2]})
                    continue
                f = item[1]
                exc = f.exception()
                if exc is None:
                    self._write_line({"result": [int(x)
                                                 for x in f.result()]})
                else:
                    self._write_line({"error": _exc_to_wire(exc)})
                return
        except (BrokenPipeError, ConnectionError, OSError):
            return  # client went away — engine keeps its own state

    # -- KV migration wire ----------------------------------------------
    def _do_export(self):
        body = json.loads(self._read_body())
        srv = self._state().srv
        try:
            ent, payload = srv.export_session(body["rid"])
        except KeyError as e:
            self._send_json(404, {"type": "KeyError", "msg": str(e)})
            return
        wire = serialize_kv_payload(payload)
        ent_b = json.dumps(_jsonable(ent)).encode()
        blob = struct.pack(">I", len(ent_b)) + ent_b + wire
        self._send_raw(200, blob, "application/octet-stream")

    def _do_import(self):
        srv = self._state().srv
        payload = deserialize_kv_payload(self._read_body())
        owner = None
        tenant = self.headers.get("X-Owner-Tenant")
        rid = self.headers.get("X-Owner-Rid")
        if tenant is not None and rid is not None:
            owner = (tenant, rid)
        tokens = (srv.import_kv_payload(payload, owner=owner)
                  if payload is not None else 0)
        self._send_json(200, {"tokens": int(tokens)})


class _WorkerHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, handler, state):
        super().__init__(addr, handler)
        self.worker_state = state
        self._shutdown_once = threading.Lock()
        self._shutting_down = False

    def initiate_shutdown(self):
        with self._shutdown_once:
            if self._shutting_down:
                return
            self._shutting_down = True
        try:
            self.worker_state.srv.stop()
        except Exception:  # noqa: BLE001 — exit anyway
            _logger.exception("worker engine stop failed")
        self.shutdown()


def serve_worker(config):
    """Worker entrypoint: build the engine, bind an ephemeral HTTP
    port, print the handshake line, and serve until shutdown."""
    import signal

    name = config.get("name", f"worker-{os.getpid()}")
    srv = build_worker_server(config)
    srv.trace_name = name
    # warm-start: capture every reachable decode graph BEFORE the
    # handshake, so a freshly spawned replica never pays a capture
    # inside a request window — /healthz/ready is
    # unreachable (no HTTP server) and false (engine not started)
    # until the warm completes. Opt out with "warm_start": false.
    if config.get("warm_start", True):
        modes = config.get("warm_modes")
        if modes is not None:
            modes = [tuple(bool(x) for x in m) for m in modes]
            srv.warm_buckets(modes)
        else:
            srv.warm_buckets()
    srv.start()
    state = _WorkerState(name, srv)
    httpd = _WorkerHTTPServer(
        (config.get("host", "127.0.0.1"), int(config.get("port", 0))),
        _WorkerHandler, state)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: threading.Thread(
            target=httpd.initiate_shutdown, daemon=True).start())
    print(f"{HANDSHAKE_PREFIX} ready "  # cli-print: stdout handshake
          f"port={httpd.server_address[1]} "  # the parent parses this
          f"pid={os.getpid()}", flush=True)
    try:
        httpd.serve_forever(poll_interval=0.2)
    finally:
        httpd.server_close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch fleet worker (subprocess replica)")
    ap.add_argument("--config", required=True,
                    help="path to a JSON worker config, or '-' for "
                         "stdin")
    args = ap.parse_args(argv)
    raw = (sys.stdin.read() if args.config == "-"
           else open(args.config).read())
    serve_worker(json.loads(raw))


# ---------------------------------------------------------------------------
# client side (runs in the router process)
# ---------------------------------------------------------------------------

class _WireRecorder:
    """`server._recorder` shim: the router's timeline export reads
    `.events()` in a try/except — fetch the worker's flight-recorder
    ring over the wire, empty on any failure."""

    def __init__(self, engine):
        self._engine = engine

    def events(self):
        try:
            return self._engine._get_json("/events")
        except Exception:  # noqa: BLE001 — timeline is best-effort
            return []


class RemoteEngine:
    """HTTP proxy speaking the engine surface the router reads:
    `submit`, `admit_journal_entry`, `export_session`,
    `import_kv_payload`, `max_new`, `max_slots`, `stats`,
    `_recorder.events()`. Futures are fed by a per-request reader
    thread pumping the worker's token stream; a cut stream fails the
    future with `ReplicaUnavailable`, which the router treats as a
    replica failure (failover), exactly like an in-process crash."""

    def __init__(self, host, port, *, name="remote",
                 probe_timeout_s=2.0, read_timeout_s=None):
        self.host = host
        self.port = int(port)
        self.trace_name = name  # Replica.__init__ overwrites
        self.probe_timeout_s = float(probe_timeout_s)
        self.read_timeout_s = (STREAM_IDLE_TIMEOUT_S + 60.0
                               if read_timeout_s is None
                               else float(read_timeout_s))
        self._recorder = _WireRecorder(self)
        info = self._get_json("/info", timeout=30.0)
        self.info = dict(info)  # connect-time worker facts (warmed, pid)
        self.max_new = int(info["max_new"])
        self.max_slots = int(info["max_slots"])
        self.enable_prefix_cache = bool(
            info.get("enable_prefix_cache", False))

    # -- plumbing --------------------------------------------------------
    def _get_json(self, path, timeout=None):
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self.probe_timeout_s if timeout is None
            else timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"GET {path} -> {resp.status}: {data[:200]!r}")
            return json.loads(data)
        finally:
            conn.close()

    def _post_raw(self, path, body, *, headers=None, timeout=None):
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self.read_timeout_s if timeout is None
            else timeout)
        try:
            conn.request("POST", path, body=body,
                         headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    # -- admission + token stream ---------------------------------------
    def submit(self, ids, max_new_tokens=None, sampling=None, *,
               meta=None, on_token=None, timeout_s=None, rid=None,
               trace_ctx=None):
        body = {
            "fresh": True,
            "ids": [int(x) for x in np.asarray(ids).reshape(-1)],
            "max_new_tokens": max_new_tokens,
            "sampling": _sampling_to_wire(sampling),
            "meta": _meta_to_wire(meta),
            "timeout_s": timeout_s,
            "rid": rid,
            "trace": (trace_ctx.to_dict() if trace_ctx is not None
                      else None),
        }
        return self._stream_submit(body, on_token, verb="submit")

    def admit_journal_entry(self, ent, on_token=None):
        body = dict(ent)
        body["fresh"] = False
        return self._stream_submit(body, on_token, verb="admit")

    def _stream_submit(self, body, on_token, verb):
        rid = body.get("rid")
        data = json.dumps(body).encode()
        if _metrics.enabled():
            _m_wire_requests.labels(verb=verb).inc()
            _m_wire_bytes.labels(direction="sent").inc(len(data))
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.read_timeout_s)
        try:
            conn.request("POST", "/submit", body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
        except Exception as e:
            conn.close()
            if _metrics.enabled():
                _m_wire_errors.labels(kind="connect").inc()
            raise ReplicaUnavailable(
                str(rid or "?"),
                f"wire connect to {self.trace_name}: "
                f"{type(e).__name__}: {e}") from e
        if resp.status != 200:
            payload = resp.read()
            conn.close()
            if _metrics.enabled():
                _m_wire_errors.labels(kind="status").inc()
            raise self._submit_error(resp.status, payload)
        _tracing.event("fleet_wire_submit", replica=self.trace_name,
                       request_id=rid, verb=verb)
        fut = Future()
        threading.Thread(
            target=self._pump, args=(conn, resp, fut, on_token, rid),
            daemon=True,
            name=f"wire-pump-{self.trace_name}").start()
        return fut

    @staticmethod
    def _submit_error(status, payload):
        try:
            err = json.loads(payload)
        except Exception:  # noqa: BLE001 — non-JSON error page
            err = {"type": "RuntimeError",
                   "msg": payload[:200].decode("utf-8", "replace")}
        if status == 429 and err.get("type") == "AdmissionShed":
            return AdmissionShed(int(err["depth"]),
                                 int(err["shed_depth"]),
                                 float(err["retry_after_s"]))
        if status == 400:
            cls = TypeError if err.get("type") == "TypeError" \
                else ValueError
            return cls(err.get("msg", "remote validation failed"))
        return RuntimeError(f"remote submit -> {status}: "
                            f"{err.get('type')}: {err.get('msg')}")

    def _pump(self, conn, resp, fut, on_token, rid):
        try:
            for raw in iter(resp.readline, b""):
                line = raw.strip()
                if not line:
                    continue
                if _metrics.enabled():
                    _m_wire_bytes.labels(direction="received").inc(
                        len(raw))
                msg = json.loads(line)
                if "tok" in msg:
                    if _metrics.enabled():
                        _m_wire_tokens.inc()
                    if on_token is not None:
                        try:
                            on_token(int(msg["tok"]),
                                     msg.get("reason"))
                        except Exception:  # noqa: BLE001
                            _logger.exception(
                                "wire on_token callback failed")
                elif "result" in msg:
                    fut.set_result(np.asarray(msg["result"],
                                              dtype=np.int32))
                    return
                elif "error" in msg:
                    fut.set_exception(
                        _exc_from_wire(msg["error"], rid))
                    return
        except Exception as e:  # noqa: BLE001 — cut stream
            if not fut.done():
                if _metrics.enabled():
                    _m_wire_errors.labels(kind="stream").inc()
                fut.set_exception(ReplicaUnavailable(
                    str(rid or "?"),
                    f"wire stream from {self.trace_name}: "
                    f"{type(e).__name__}: {e}"))
            return
        finally:
            conn.close()
        if not fut.done():
            # EOF without a terminal line: the worker died mid-stream
            if _metrics.enabled():
                _m_wire_errors.labels(kind="stream").inc()
            fut.set_exception(ReplicaUnavailable(
                str(rid or "?"),
                f"wire stream from {self.trace_name} closed "
                f"mid-request"))

    # -- KV migration wire ----------------------------------------------
    def export_session(self, rid):
        if _metrics.enabled():
            _m_wire_requests.labels(verb="export").inc()
        status, data = self._post_raw(
            "/export", json.dumps({"rid": rid}).encode(),
            headers={"Content-Type": "application/json"})
        if status == 404:
            raise KeyError(rid)
        if status != 200:
            raise RuntimeError(f"wire export {rid!r} -> {status}: "
                               f"{data[:200]!r}")
        if _metrics.enabled():
            _m_wire_bytes.labels(direction="received").inc(len(data))
        (n,) = struct.unpack(">I", data[:4])
        ent = json.loads(data[4:4 + n].decode())
        # int8 KV pools round-trip the codec bit-exactly, so the
        # router's own serialize->deserialize pass reproduces these
        # bytes; dense pools re-quantize (tolerance-gated) — pair the
        # wire with kv_dtype="int8" when exact parity matters.
        return ent, deserialize_kv_payload(data[4 + n:])

    def import_kv_payload(self, payload, owner=None):
        wire = serialize_kv_payload(payload)
        headers = {"Content-Type": "application/octet-stream"}
        if owner is not None:
            headers["X-Owner-Tenant"] = str(owner[0])
            headers["X-Owner-Rid"] = str(owner[1])
        if _metrics.enabled():
            _m_wire_requests.labels(verb="import").inc()
            _m_wire_bytes.labels(direction="sent").inc(len(wire))
        status, data = self._post_raw("/import", wire,
                                      headers=headers)
        if status != 200:
            raise RuntimeError(f"wire import -> {status}: "
                               f"{data[:200]!r}")
        return int(json.loads(data)["tokens"])

    # -- misc engine surface ---------------------------------------------
    def set_draining(self, draining=True):
        status, data = self._post_raw(
            "/drain",
            json.dumps({"draining": bool(draining)}).encode(),
            headers={"Content-Type": "application/json"},
            timeout=self.probe_timeout_s)
        if status != 200:
            raise RuntimeError(f"wire drain -> {status}: "
                               f"{data[:200]!r}")
        return self

    def stats(self):
        return self._get_json("/stats", timeout=self.probe_timeout_s)

    def capacity_snapshot(self):
        return self._get_json("/capacity",
                              timeout=self.probe_timeout_s)


class RemoteReplica(Replica):
    """A fleet replica whose engine lives in ANOTHER OS process.

    Speaks the identical replica protocol (`Replica`), so the router
    does not know or care: probes are HTTP GETs with short timeouts
    (a hung or dead worker reads as not-live and the ordinary
    failover runs), placement signals (`load`, `prefix_match_len`)
    degrade safely on wire errors, and `kill()` is a real SIGKILL —
    the chaos gates exercise a true process death.
    """

    def __init__(self, name, engine, *, proc=None, health=None,
                 stderr_path=None, config_path=None,
                 keep_alive_on_stop=False):
        super().__init__(name, engine, health=health)
        self._proc = proc
        self._stderr_path = stderr_path
        self._config_path = config_path
        self._keep_alive_on_stop = bool(keep_alive_on_stop)

    # -- spawning --------------------------------------------------------
    @classmethod
    def spawn(cls, name, config, *, health=None,
              startup_timeout_s=180.0, python=None, env=None,
              keep_alive_on_stop=False):
        """Launch `python -m paddle_tpu_torch.fleet.transport` with
        `config` (see `build_worker_server`), wait for the handshake
        line, and return a connected replica. The child inherits the
        parent environment (with this checkout first on PYTHONPATH)
        plus `env` overrides; stderr goes to a temp log whose tail is
        surfaced on startup failure. On the card the worker builds no
        kernel that the checkout's build directory already holds."""
        cfg = dict(config)
        cfg.setdefault("name", name)
        cf = tempfile.NamedTemporaryFile(
            "w", suffix=".json", prefix=f"ptpu-worker-{name}-",
            delete=False)
        json.dump(cfg, cf)
        cf.close()
        ef = tempfile.NamedTemporaryFile(
            "wb", suffix=".log", prefix=f"ptpu-worker-{name}-",
            delete=False)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        penv = dict(os.environ)
        penv["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + ([penv["PYTHONPATH"]]
                           if penv.get("PYTHONPATH") else []))
        if env:
            penv.update(env)
        proc = subprocess.Popen(
            [python or sys.executable, "-m",
             "paddle_tpu_torch.fleet.transport", "--config", cf.name],
            stdout=subprocess.PIPE, stderr=ef, env=penv)
        ef.close()
        try:
            port = cls._await_handshake(proc, startup_timeout_s,
                                        ef.name)
            engine = RemoteEngine("127.0.0.1", port, name=name)
        except Exception:
            try:
                proc.kill()
            except Exception:  # noqa: BLE001
                pass
            raise
        rep = cls(name, engine, proc=proc, health=health,
                  stderr_path=ef.name, config_path=cf.name,
                  keep_alive_on_stop=keep_alive_on_stop)
        rep._started = True  # the worker engine is live from spawn
        return rep

    @staticmethod
    def _await_handshake(proc, timeout_s, stderr_path):
        lines = queue.Queue()

        def _reader():
            for raw in iter(proc.stdout.readline, b""):
                lines.put(raw)
            lines.put(None)

        threading.Thread(target=_reader, daemon=True,
                         name="wire-handshake").start()
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                raw = lines.get(timeout=max(
                    0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(
                    f"worker handshake timed out after {timeout_s:g}s"
                    f"; stderr tail: "
                    f"{_tail(stderr_path)!r}") from None
            if raw is None:
                raise RuntimeError(
                    f"worker exited before handshake (rc="
                    f"{proc.poll()}); stderr tail: "
                    f"{_tail(stderr_path)!r}")
            line = raw.decode("utf-8", "replace").strip()
            if line.startswith(HANDSHAKE_PREFIX):
                fields = dict(kv.split("=", 1)
                              for kv in line.split()[1:]
                              if "=" in kv)
                # keep draining stdout so the child never blocks on a
                # full pipe
                threading.Thread(
                    target=lambda: proc.stdout.read(),
                    daemon=True, name="wire-stdout-drain").start()
                return int(fields["port"])

    # -- lifecycle -------------------------------------------------------
    def start(self):
        with self._lock:
            self._started = True  # worker engine started at spawn
        return self

    def stop(self):
        with self._lock:
            if not self._started or self._killed:
                self._started = False
                return
            self._started = False
        if self._keep_alive_on_stop:
            return  # caller owns the process (call terminate())
        self.terminate()

    def terminate(self, timeout_s=20.0):
        """Full teardown: graceful /shutdown, then escalate."""
        if self._proc is None:
            return
        try:
            self.server._post_raw("/shutdown", b"", timeout=5.0)
        except Exception:  # noqa: BLE001 — escalate below
            pass
        try:
            self._proc.wait(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — escalate
            try:
                self._proc.terminate()
                self._proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001 — last resort
                try:
                    self._proc.kill()
                    self._proc.wait(timeout=5.0)
                except Exception:  # noqa: BLE001
                    pass

    def kill(self):
        """Chaos hook: a REAL process death (SIGKILL) — in-flight
        streams cut mid-request, probes refuse, and the router's
        journaled failover re-admits the sessions elsewhere."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        self.health.mark_dead("killed")
        if self._proc is not None:
            try:
                self._proc.kill()
            except Exception:  # noqa: BLE001 — already gone
                pass
        _logger.warning("remote replica %s killed (pid %s)",
                        self.name,
                        getattr(self._proc, "pid", "?"))

    # -- probe surface ---------------------------------------------------
    def liveness(self):
        if self._killed:
            return False, {"engine_running": False, "killed": True}
        try:
            r = self.server._get_json("/healthz/live")
            return bool(r.get("live")), r.get("detail", {})
        except Exception as e:  # noqa: BLE001 — dead wire = not live
            return False, {"wire_error": f"{type(e).__name__}: {e}"}

    def readiness(self):
        if self._killed:
            return False, {"killed": True}
        try:
            r = self.server._get_json("/healthz/ready")
            return bool(r.get("ready")), r.get("detail", {})
        except Exception as e:  # noqa: BLE001
            return False, {"wire_error": f"{type(e).__name__}: {e}"}

    def load(self):
        try:
            return int(self.server._get_json("/load")["load"])
        except Exception:  # noqa: BLE001 — avoid placing on a replica
            return 1 << 30  # we cannot even probe

    def queue_depth(self):
        try:
            return int(self.server._get_json("/load")["queue_depth"])
        except Exception:  # noqa: BLE001
            return 0

    def prefix_match_len(self, ids):
        if self.dead or not self.server.enable_prefix_cache:
            return 0
        try:
            status, data = self.server._post_raw(
                "/match_prefix",
                json.dumps({"ids": [int(x) for x in
                                    np.asarray(ids).reshape(-1)]}
                           ).encode(),
                headers={"Content-Type": "application/json"},
                timeout=self.server.probe_timeout_s)
            if status != 200:
                return 0
            return int(json.loads(data)["match_len"])
        except Exception:  # noqa: BLE001 — placement is advisory
            return 0

    def capacity(self):
        if self.dead:
            raise RuntimeError(f"replica {self.name} is dead")
        # probe-timeout-bounded: a hung worker raises here and the
        # federation layer (with its own timeout guard) converts that
        # into the snapshot's error slot
        return self.server.capacity_snapshot()

    def metrics_text(self):
        try:
            conn = http.client.HTTPConnection(
                self.server.host, self.server.port,
                timeout=self.server.probe_timeout_s)
            try:
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise RuntimeError(f"/metrics -> {resp.status}")
                return body.decode("utf-8", "replace")
            finally:
                conn.close()
        except Exception as e:  # noqa: BLE001 — federation tolerates
            return (f"# replica {self.name} unreachable: "
                    f"{type(e).__name__}: {e}\n")


def _tail(path, n=800):
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - n))
            return f.read().decode("utf-8", "replace")
    except Exception:  # noqa: BLE001 — diagnostics only
        return ""


if __name__ == "__main__":
    main()
