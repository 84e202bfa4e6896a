"""Token-by-token streaming for the serving front door: the port's copy of
`paddle_tpu.frontend.stream`.

The engine (`PagedGenerationServer._slot_token`) invokes a per-request
`on_token(token, reason)` callback from its loop thread for every
generated token. This module turns that callback into a consumer-facing
stream:

  * `DeltaAssembler` — incremental detokenization with STOP-STRING-SAFE
    release: before any delta is handed out, the tail of the
    accumulated text is re-checked against the request's stop strings
    (bounded-tail, like the engine's own stop check) and any suffix
    that could still grow into a stop string is HELD BACK. Released
    text therefore never contains a suppressed stop-string suffix —
    not even transiently, token by token (the round-12 satellite fix).
  * `StreamHandle` — the object `FrontDoor.submit` returns: an
    iterator of `StreamEvent`s plus the classic `result()` future
    surface. Delivery is BACKPRESSURE-AWARE without ever blocking the
    engine: the event buffer is bounded, and once a slow consumer
    falls `max_buffered` events behind, new deltas COALESCE into the
    newest undelivered event (text concatenated, token ids appended)
    instead of growing the queue — memory stays bounded, no token or
    character is ever dropped, and the consumer simply sees coarser
    events until it catches up.

Detokenizer contract: deltas are computed over a bounded token tail
(`tail_tokens`, the engine's `stop_tail_tokens` by default), so the
`detokenize` callable must be prefix-stable within that window —
appending one token may only append characters. This is the same
contract the engine's host-side stop-string check already relies on.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from ..observability import metrics as _metrics
from ..reliability import QuarantinedRequest, RequestTimeout

_m_stream_events = _metrics.counter(
    "frontdoor_stream_events_total",
    "stream events delivered to consumers (post-coalescing)")
_m_stream_coalesced = _metrics.counter(
    "frontdoor_stream_coalesced_total",
    "token deltas merged into an undelivered event because the "
    "consumer fell max_buffered events behind (backpressure)")


@dataclass
class StreamEvent:
    """One streamed increment: `text` is the SAFE detokenized delta
    (may be empty while the assembler holds back a possible
    stop-string prefix, or when the server has no detokenizer),
    `token_ids` the raw tokens it covers. On the final event `done` is
    True and `stop_reason` is one of eos / stop_token / stop_string /
    budget (or "error" if the request failed)."""
    text: str = ""
    token_ids: tuple = ()
    done: bool = False
    stop_reason: str | None = None


class DeltaAssembler:
    """Stop-string-safe incremental detokenizer.

    push(tok) returns the text this token makes SAFE to release; the
    unreleased remainder (a suffix that is a proper prefix of some
    stop string, or everything from a completed match onward) stays
    pending. finish(reason) flushes: for reason == "stop_string" the
    earliest stop-string match and everything after it is suppressed;
    any other reason releases the pending text verbatim.

    Invariant (inductive): released text never ends with a non-empty
    proper prefix of a stop string, so every possible match lies
    entirely inside the pending buffer and can still be suppressed.
    """

    def __init__(self, detokenize, stop_strings=(), tail_tokens=16):
        if detokenize is None:
            raise ValueError("DeltaAssembler needs a detokenize callable")
        self._detok = detokenize
        self._stops = tuple(s for s in (stop_strings or ()) if s)
        self._w = max(1, int(tail_tokens))
        self._toks: list[int] = []
        self._pending = ""

    def _delta(self, tok):
        """Text `tok` appends, over the bounded tail window."""
        prev = self._toks[-(self._w - 1):] if self._w > 1 else []
        self._toks.append(tok)
        before = self._detok(prev) if prev else ""
        after = self._detok(prev + [tok])
        return after[len(before):]

    def _earliest_match(self, text):
        cut = None
        for s in self._stops:
            j = text.find(s)
            if j >= 0:
                cut = j if cut is None else min(cut, j)
        return cut

    def _holdback(self):
        """Longest suffix of pending that is a PROPER prefix of some
        stop string — the characters that could still grow into a
        match and must not be released yet."""
        h = 0
        for s in self._stops:
            for ln in range(min(len(s) - 1, len(self._pending)), h, -1):
                if self._pending.endswith(s[:ln]):
                    h = ln
                    break
        return h

    def push(self, tok):
        """Feed one generated token; returns the safe-to-release text
        (possibly empty)."""
        self._pending += self._delta(int(tok))
        if not self._stops:
            out, self._pending = self._pending, ""
            return out
        cut = self._earliest_match(self._pending)
        if cut is not None:
            # a full stop string is present: release only the text
            # before it; the match (and anything after) can only ever
            # be suppressed or re-examined at finish()
            out = self._pending[:cut]
            self._pending = self._pending[cut:]
            return out
        h = self._holdback()
        out = self._pending[:len(self._pending) - h]
        self._pending = self._pending[len(self._pending) - h:]
        return out

    def finish(self, reason):
        """Flush at end of generation. Returns the final releasable
        text (the suppressed stop string never appears in it)."""
        out, self._pending = self._pending, ""
        if reason == "stop_string" and self._stops:
            cut = self._earliest_match(out)
            if cut is not None:
                out = out[:cut]
        return out

    @property
    def pending(self):
        return self._pending


class StreamHandle:
    """Consumer handle for one streamed request.

    Iterate for `StreamEvent`s (blocks until events arrive; ends after
    the final event), or call `result(timeout)` for the classic full
    [prompt + generated] array. `text()` returns the released text so
    far; `stop_reason`/`done` report final state. The producer side
    (`_on_token`, engine thread) never blocks: past `max_buffered`
    undelivered events, deltas coalesce into the newest one.

    timeout_s: per-GAP iterator timeout — iterating raises
    `TimeoutError` when no event arrives for this many seconds, so a
    dead or wedged engine can never hang a consumer thread forever
    (the iterator-side twin of `result(timeout=)`). Streams whose
    request was quarantined or timed out by the engine terminate with
    `stop_reason` "quarantined" / "timeout" instead of "error".
    """

    def __init__(self, detokenize=None, stop_strings=(),
                 tail_tokens=16, max_buffered=256, timeout_s=None):
        self._asm = (DeltaAssembler(detokenize, stop_strings,
                                    tail_tokens)
                     if detokenize is not None else None)
        self._cv = threading.Condition()
        self._events: deque[StreamEvent] = deque()
        self._tokens: list[int] = []
        self._chunks: list[str] = []
        self._done = False
        self._stop_reason: str | None = None
        self._max = max(1, int(max_buffered))
        if timeout_s is not None and float(timeout_s) <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self._timeout = None if timeout_s is None else float(timeout_s)
        self.coalesced = 0
        self._future = None
        self._bind_gen = 0  # rebind epoch: stale futures are ignored

    # ---- producer side (engine thread) --------------------------------
    def _on_token(self, tok, reason):
        tok = int(tok)
        delta = ""
        if self._asm is not None:
            delta = self._asm.push(tok)
            if reason is not None:
                delta += self._asm.finish(reason)
        with self._cv:
            self._tokens.append(tok)
            if delta:
                self._chunks.append(delta)
            if len(self._events) >= self._max:
                last = self._events[-1]  # coalesce: bounded memory,
                last.text += delta       # engine never blocks
                last.token_ids += (tok,)
                self.coalesced += 1
                _m_stream_coalesced.inc()
            else:
                self._events.append(StreamEvent(text=delta,
                                                token_ids=(tok,)))
            if reason is not None:
                self._events[-1].done = True
                self._events[-1].stop_reason = reason
                self._done = True
                self._stop_reason = reason
            self._cv.notify_all()

    def _bind(self, future):
        """Attach the engine future; a request that dies without a
        final token (dispatch failure, server stop) still terminates
        the stream via the future's done callback."""
        with self._cv:
            self._future = future
            self._bind_gen += 1
            gen = self._bind_gen
        future.add_done_callback(
            lambda f: self._on_future_done(f, gen))
        return self

    def rebind(self, future):
        """RE-ATTACH the stream to a new engine future (fleet round:
        failover/migration moved the session to another replica).
        Token delivery simply continues — the new replica resumes at
        the next undelivered token, so the consumer sees one
        uninterrupted stream — and any terminal outcome of the OLD
        future after this point is ignored (its generation is stale).
        `result()` now reports the new future's outcome. No-op safe
        on a stream that already finished."""
        return self._bind(future)

    def _on_future_done(self, fut, gen=None):
        with self._cv:
            if gen is not None and gen != self._bind_gen:
                return  # stale binding: the stream was rebound
            if not self._done:
                self._done = True
                exc = fut.exception()
                if exc is not None:
                    # quarantine / timeout terminations are their
                    # own stop reasons, not a generic "error"
                    if isinstance(exc, QuarantinedRequest):
                        reason = "quarantined"
                    elif isinstance(exc, RequestTimeout):
                        reason = "timeout"
                    else:
                        reason = "error"
                    self._stop_reason = reason
                    self._events.append(StreamEvent(
                        done=True, stop_reason=reason))
            self._cv.notify_all()

    # ---- consumer side -------------------------------------------------
    def __iter__(self):
        while True:
            deadline = (None if self._timeout is None
                        else time.monotonic() + self._timeout)
            with self._cv:
                while not self._events and not self._done:
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"stream produced no event for "
                            f"{self._timeout:g}s (engine dead or "
                            f"wedged?)")
                    self._cv.wait(timeout=0.1)
                if self._events:
                    ev = self._events.popleft()
                else:
                    return  # done and drained
            _m_stream_events.inc()
            yield ev
            if ev.done:
                return

    def result(self, timeout=None):
        """The classic submit/drain surface: the full
        [prompt + generated] int32 array (raises what the engine
        raised)."""
        return self._future.result(timeout=timeout)

    def text(self):
        """Released text so far (never includes a suppressed stop
        string suffix)."""
        with self._cv:
            return "".join(self._chunks)

    @property
    def tokens(self):
        with self._cv:
            return list(self._tokens)

    @property
    def done(self):
        with self._cv:
            return self._done

    @property
    def stop_reason(self):
        with self._cv:
            return self._stop_reason
