"""Drafters: cheap per-slot token proposers for speculative decoding (the
port of `paddle_tpu.spec_decode.drafter`; pure host numpy).

A drafter sees ONE slot's full context (prompt + every token generated
so far) each scheduler round and proposes up to `max_tokens` likely next
tokens. Proposals are free to be wrong — the packed verification
dispatch accepts exactly the prefix the target model would have emitted
and the paged cache rolls the rest back — so a drafter's only job is to
be cheap and right often enough to pay for the verify dispatch.

`NgramDrafter` is the self-drafting baseline (prompt-lookup decoding):
no second model, no device work — the proposal is a suffix-match lookup
over the slot's own token history, which is exactly right for the
repetitive/agentic traffic speculation targets (code, tool-call loops,
quote-heavy chat, structured output).

`DraftModelDrafter` is the seam for a real draft model: any model
sharing the target's tokenizer whose `generate(ids, n)` returns a
greedy continuation can propose. This seam runs one B=1 generate per
slot per round — correct but dispatch-heavy; a production drafter would
keep its own paged cache and batch its proposals (that engine plugs in
through the same one-method protocol).
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """One method: propose up to `max_tokens` continuations of
    `token_ids` (the slot's prompt + generated tokens, 1-D int array).
    Return a 1-D int array of 0..max_tokens proposals — an empty return
    means "no idea", and the slot takes plain decode this round."""

    def propose(self, token_ids, max_tokens: int): ...


class NgramDrafter:
    """Self-drafting n-gram / prompt-lookup drafter.

    Finds the longest suffix of the context (between `min_match` and
    `max_match` tokens, longest first) that also occurs EARLIER in the
    context, and proposes the tokens that followed that most recent
    earlier occurrence. O(context · max_match) numpy compares per call —
    microseconds at serving context lengths, no device work.
    """

    def __init__(self, max_match=3, min_match=1):
        self.max_match = int(max_match)
        self.min_match = int(min_match)
        if not 1 <= self.min_match <= self.max_match:
            raise ValueError(
                f"need 1 <= min_match <= max_match, got "
                f"min_match={min_match!r} max_match={max_match!r}")

    def propose(self, token_ids, max_tokens):
        ctx = np.asarray(token_ids).reshape(-1)
        n = int(ctx.size)
        max_tokens = int(max_tokens)
        if max_tokens < 1 or n < self.min_match + 1:
            return np.empty((0,), np.int32)
        for m in range(min(self.max_match, n - 1), self.min_match - 1,
                       -1):
            pattern = ctx[n - m:]
            # candidate starts i < n - m (a PROPER earlier occurrence,
            # so at least one follow token exists at i + m <= n - 1)
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:n - 1], m)                  # starts 0 .. n-m-1
            hits = np.flatnonzero((windows == pattern).all(axis=1))
            if hits.size == 0:
                continue
            # PERIODIC EXTENSION off the most recent occurrence: the
            # suffix recurring d = (n-m) - i tokens before itself is
            # evidence of a period-d pattern, so extrapolate the d
            # tokens after the occurrence cyclically. This always
            # fills max_tokens (index i+m+(j mod d) <= n-1 by
            # construction) — without it, a fresh token run could
            # never be proposed further than it has already repeated,
            # capping every early proposal at 1-2 tokens.
            i = int(hits[-1])
            d = (n - m) - i
            idx = i + m + (np.arange(max_tokens) % d)
            return ctx[idx].astype(np.int32)
        return np.empty((0,), np.int32)


class DraftModelDrafter:
    """Model-based drafting seam: greedy-continue the context with a
    small causal LM sharing the target tokenizer. `model` is anything
    with `generate(ids[1, S], n) -> [1, S + n]` (numpy, or a tensor on
    any device). Note the cost model in the module docstring: one
    generate per slot per round."""

    def __init__(self, model):
        self._model = model

    def propose(self, token_ids, max_tokens):
        ctx = np.asarray(token_ids, np.int32).reshape(-1)
        max_tokens = int(max_tokens)
        if max_tokens < 1 or ctx.size == 0:
            return np.empty((0,), np.int32)
        out = self._model.generate(ctx[None], max_tokens)
        if hasattr(out, "cpu"):  # a tensor: read it back to the host
            out = out.cpu().numpy()
        out = np.asarray(out)[0]
        return out[ctx.size:].astype(np.int32)
