"""Crash-consistent session journal: the port's copy of
`paddle_tpu.reliability.journal`. The record format is the
reference's byte for byte, so either package's journal reads the
other's.

A bounded APPEND-ONLY record of every accepted request and every token
it emitted, from which a fresh `PagedGenerationServer` can re-admit
whatever a dead engine left unfinished — an engine restart loses zero
accepted requests, and because the whole decode stack is deterministic
(counter-based per-request PRNG, residency-invariant positions), the
re-admitted requests complete with tokens IDENTICAL to the run that
never crashed.

Record stream (JSON lines, one flush per line so a crash tears at most
the final line — the loader skips a torn tail):

    {"t":"accept","rid":...,"ids":[...],"gen0":[...],"budget":...,
     "seed":...,"sampling":{...},...}     request accepted (gen0
                                          non-empty when re-accepted
                                          after a previous restart)
    {"t":"tok","rid":...,"tok":N}         one emitted token
    {"t":"done","rid":...,"reason":...}   terminal: completed,
                                          quarantined, or timed out

Boundedness: when the file grows past `max_bytes` it is COMPACTED —
rewritten (atomically, via os.replace) with one `accept` record per
still-live request, its emitted tokens folded into `gen0`, and every
finished request dropped. The journal therefore costs O(live requests
+ recent tokens) disk, not O(session length).

Concurrency: appends and compaction are safe to race
from any number of threads. Appends serialize on the state lock;
compaction is COPY-ON-COMPACT — it snapshots the live state under the
lock, writes the replacement file OUTSIDE the lock (appends keep
landing in the old file meanwhile, and are buffered), then atomically
replays the buffered records into the new file and swaps it in. A
record can therefore never be torn or lost by a concurrent
compaction, and appends are never blocked for the duration of the
rewrite (a threaded stress test holds it).

What is recoverable: accepted requests that have not reached a
terminal record — they re-admit with their original prompt, recorded
seed, budget and sampling params, resuming at PRNG step len(gen0).
What is NOT: quarantined / timed-out / completed requests (terminal by
design), per-tenant rate-bucket levels, and the stats window — see
docs/RELIABILITY.md.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, is_dataclass

DEFAULT_MAX_BYTES = 4 << 20  # 4 MiB before compaction


class SessionJournal:
    """Append-only request journal with compaction.

    path: journal file (created on first append; an existing file is
        LOADED first, so a restarted process keeps appending to the
        same session).
    max_bytes: compaction threshold for the on-disk file.
    fsync: fsync after every line (true crash-consistency against
        power loss; default off — flush-per-line already survives
        process death, which is the failure mode tests exercise).
    """

    def __init__(self, path, max_bytes=DEFAULT_MAX_BYTES, fsync=False):
        self.path = os.fspath(path)
        self.max_bytes = int(max_bytes)
        if self.max_bytes < 1024:
            raise ValueError(f"max_bytes must be >= 1024, "
                             f"got {max_bytes}")
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        # one compaction at a time; a second thread finding the file
        # still over budget after the gate simply compacts again
        self._compact_gate = threading.Lock()
        # while a compaction is writing the replacement file, every
        # appended line is also buffered here and replayed into the
        # new file before the atomic swap (copy-on-compact)
        self._compact_buf: list | None = None
        # rid -> {"ent": accept-dict, "toks": [...], "done": reason|None}
        # (insertion-ordered: interrupted() re-admits in accept order)
        self._state: dict[str, dict] = {}
        self._f = None
        self._bytes = 0
        self._torn_lines = 0
        if os.path.exists(self.path):
            self._load()

    # -- loading ---------------------------------------------------------
    def _load(self):
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    self._torn_lines += 1  # torn tail of a crashed run
                    continue
                self._apply(rec)
                self._bytes += len(line) + 1

    def _apply(self, rec):
        t = rec.get("t")
        rid = rec.get("rid")
        if t == "accept":
            self._state[rid] = {"ent": rec, "toks": [], "done": None}
        elif t == "tok" and rid in self._state:
            self._state[rid]["toks"].append(int(rec["tok"]))
        elif t == "done" and rid in self._state:
            self._state[rid]["done"] = rec.get("reason", "done")

    # -- appending -------------------------------------------------------
    def _append_locked(self, rec):
        if self._f is None:
            self._f = open(self.path, "a", encoding="utf-8")
        line = json.dumps(rec, separators=(",", ":"))
        self._f.write(line + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._bytes += len(line) + 1
        if self._compact_buf is not None:
            # a compaction is rewriting the file right now: this line
            # landed in the old file (about to be replaced), so buffer
            # it for verbatim replay into the new one
            self._compact_buf.append(line)

    def _record(self, rec):
        with self._lock:
            self._apply(rec)
            self._append_locked(rec)
            over = self._bytes > self.max_bytes
        if over:
            # OUTSIDE the state lock: copy-on-compact never blocks a
            # concurrent append on the rewrite I/O
            self._compact(force=False)

    @staticmethod
    def entry_for(req):
        """The journal-shape resume state of one engine request (rid,
        ids, gen0, budget, seed, sampling, timeout_s, meta) — exactly
        what `PagedGenerationServer.admit_journal_entry` consumes.
        Shared by `record_accept` and the fleet router/migration path,
        so a session serialized for replica takeover is byte-for-byte
        the state a journal recovery would rebuild."""
        sampling = getattr(req, "sampling", None)
        meta = getattr(req, "meta", None)
        ent = {
            "rid": req.rid,
            "ids": [int(x) for x in req.ids],
            "gen0": [int(x) for x in getattr(req, "gen0", ())],
            "budget": int(req.budget),
            "seed": int(req.seed),
            "timeout_s": getattr(req, "timeout_s", None),
            "sampling": (asdict(sampling) if is_dataclass(sampling)
                         else None),
        }
        if meta is not None:
            ent["meta"] = {"lane": meta.lane, "tenant": meta.tenant,
                           "deadline_s": meta.deadline_s,
                           "cost": meta.cost}
        trace = getattr(req, "trace", None)
        if trace is not None:
            # causal tracing: the TraceContext rides the
            # journal-shape entry, so a ring dump, a journal replay,
            # a failover re-admission, and a migration all correlate
            # with the live trace stream by trace_id
            ent["trace"] = trace.to_dict()
        return ent

    def record_accept(self, req):
        """Journal one accepted request (an engine `_Req`: rid, ids,
        gen0, budget, seed, sampling, meta, timeout_s are read)."""
        self._record({"t": "accept", **self.entry_for(req)})

    def record_token(self, rid, tok):
        self._record({"t": "tok", "rid": rid, "tok": int(tok)})

    def record_done(self, rid, reason):
        self._record({"t": "done", "rid": rid, "reason": str(reason)})

    # -- compaction ------------------------------------------------------
    def compact(self):
        """Force a compaction now (normally automatic past max_bytes).
        Safe to race appends from other threads: copy-on-compact."""
        self._compact(force=True)

    def _compact(self, force):
        with self._compact_gate:
            with self._lock:
                if not force and self._bytes <= self.max_bytes:
                    return  # a racing compactor already did the work
                # snapshot (st ref + copies): the copies feed the
                # rewrite outside the lock, the ref detects a re-accept
                # replacing the entry mid-compaction
                snap = [(st, dict(st["ent"]), list(st["toks"]))
                        for st in self._state.values()
                        if st["done"] is None]
                self._compact_buf = []
            tmp = self.path + ".compact"
            f = open(tmp, "w", encoding="utf-8")
            try:
                nbytes = 0
                for _st, ent, toks in snap:
                    ent["gen0"] = list(ent.get("gen0", [])) + toks
                    line = json.dumps(ent, separators=(",", ":"))
                    f.write(line + "\n")
                    nbytes += len(line) + 1
                with self._lock:
                    # records appended while the rewrite ran: replay
                    # them verbatim, then swap atomically — nothing a
                    # racing writer appended is ever lost or torn
                    for line in self._compact_buf:
                        f.write(line + "\n")
                        nbytes += len(line) + 1
                    self._compact_buf = None
                    f.flush()
                    os.fsync(f.fileno())
                    f.close()
                    if self._f is not None:
                        self._f.close()
                        self._f = None
                    os.replace(tmp, self.path)
                    # fold ONLY the snapshotted tokens into each
                    # entry's gen0; tokens that raced the rewrite were
                    # replayed above and stay in toks. An entry a
                    # re-accept replaced mid-compaction keeps its new
                    # state (its accept line was replayed too).
                    for st, ent, toks in snap:
                        cur = self._state.get(ent.get("rid"))
                        if cur is not st:
                            continue
                        st["ent"] = ent
                        del st["toks"][:len(toks)]
                    self._state = {rid: st for rid, st
                                   in self._state.items()
                                   if st["done"] is None}
                    self._bytes = nbytes
            except BaseException:
                with self._lock:
                    self._compact_buf = None
                try:
                    f.close()
                except Exception:  # noqa: BLE001 — already closed
                    pass
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise

    # -- recovery --------------------------------------------------------
    def interrupted(self):
        """Every accepted request with no terminal record, in accept
        order: [{rid, ids, gen0, budget, seed, sampling, timeout_s,
        meta?}] with emitted tokens folded into gen0 — exactly the
        resume state `PagedGenerationServer.recover_from_journal`
        re-admits."""
        with self._lock:
            out = []
            for rid, st in self._state.items():
                if st["done"] is not None:
                    continue
                ent = dict(st["ent"])
                ent["gen0"] = list(ent.get("gen0", [])) + st["toks"]
                ent.pop("t", None)
                out.append(ent)
            return out

    def stats(self):
        with self._lock:
            done = sum(1 for st in self._state.values()
                       if st["done"] is not None)
            return {
                "path": self.path,
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "accepted": len(self._state),
                "finished": done,
                "interrupted": len(self._state) - done,
                "torn_lines": self._torn_lines,
            }

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                if self.fsync:
                    os.fsync(self._f.fileno())

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
