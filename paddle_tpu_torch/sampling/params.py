"""Per-request sampling parameters with EAGER validation.

`SamplingParams` is the one request-level knob bundle of the serving
stack: temperature / top-k / top-p / min-p, the three penalties, an
optional reproducibility seed, stop conditions, and a per-request token
budget. Validation happens in `__post_init__` — a bad value raises a
ValueError that NAMES the offending field and value at `submit()` time,
instead of surfacing later inside a decode dispatch. (A copy of
`paddle_tpu.sampling.params`; the port imports nothing of the JAX
package.)

The dataclass is frozen: instances are shared freely between the
client thread, the scheduler, and the slot parameter buffers without
copy or lock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def _check_finite(name, v, lo=None, hi=None, lo_open=False):
    """Reject NaN/inf and range violations, naming field and value."""
    v = float(v)
    if math.isnan(v) or math.isinf(v):
        raise ValueError(f"{name} must be finite, got {v!r}")
    if lo is not None and (v <= lo if lo_open else v < lo):
        bound = f"> {lo}" if lo_open else f">= {lo}"
        raise ValueError(f"{name} must be {bound}, got {v!r}")
    if hi is not None and v > hi:
        raise ValueError(f"{name} must be <= {hi}, got {v!r}")
    return v


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode configuration.

    temperature: 0.0 = greedy (bitwise-identical to the pre-sampling
        argmax path); > 0 samples from the scaled distribution.
    top_k: keep only the k highest-probability tokens (0 = off).
    top_p: nucleus — keep the smallest set of tokens whose cumulative
        probability reaches top_p, in (0, 1]; 1.0 = off.
    min_p: drop tokens whose probability is below min_p * max-prob,
        in [0, 1); 0.0 = off.
    repetition_penalty: HF-style — logits of tokens already seen
        (prompt + generated) are divided (if > 0) / multiplied (if < 0)
        by this; 1.0 = off.
    presence_penalty / frequency_penalty: OpenAI-style additive
        penalties on seen tokens (flat / per-occurrence); 0.0 = off.
    seed: per-request PRNG stream seed. A fixed seed reproduces the
        sampled tokens REGARDLESS of batch composition or slot index
        (counter-based streams: fold_in(seed, step)). None = the server
        derives a unique seed per request.
    stop_token_ids: generation stops when any of these ids is emitted
        (checked on device, like EOS; the stop token is kept in the
        output).
    stop_strings: generation stops when the detokenized tail of the
        output contains any of these strings (checked host-side;
        requires the server to be built with a `detokenize` callable).
    max_new_tokens: per-request budget; None = the server default.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int | None = None
    stop_token_ids: tuple = field(default_factory=tuple)
    stop_strings: tuple = field(default_factory=tuple)
    max_new_tokens: int | None = None

    def __post_init__(self):
        set_ = object.__setattr__
        set_(self, "temperature",
             _check_finite("temperature", self.temperature, lo=0.0))
        try:
            tk = int(self.top_k)
            if tk != self.top_k or tk < 0:
                raise ValueError
        except (TypeError, ValueError):
            raise ValueError(
                f"top_k must be an int >= 0, got {self.top_k!r}") from None
        set_(self, "top_k", tk)
        # top_p in (0, 1]: 0 would keep no tokens at all
        set_(self, "top_p",
             _check_finite("top_p", self.top_p, lo=0.0, hi=1.0,
                           lo_open=True))
        # min_p in [0, 1): 1 would drop everything but exact-max ties
        mp = _check_finite("min_p", self.min_p, lo=0.0)
        if mp >= 1.0:
            raise ValueError(f"min_p must be < 1, got {self.min_p!r}")
        set_(self, "min_p", mp)
        set_(self, "repetition_penalty",
             _check_finite("repetition_penalty", self.repetition_penalty,
                           lo=0.0, lo_open=True))
        set_(self, "presence_penalty",
             _check_finite("presence_penalty", self.presence_penalty))
        set_(self, "frequency_penalty",
             _check_finite("frequency_penalty", self.frequency_penalty))
        if self.seed is not None:
            try:
                sd = int(self.seed)
            except (TypeError, ValueError):
                raise ValueError(f"seed must be an int or None, "
                                 f"got {self.seed!r}")
            set_(self, "seed", sd & 0xFFFFFFFF)
        stop_ids = tuple(self.stop_token_ids)
        for t in stop_ids:
            if int(t) < 0:
                raise ValueError(
                    f"stop_token_ids must be >= 0, got {t!r}")
        set_(self, "stop_token_ids", tuple(int(t) for t in stop_ids))
        stops = tuple(self.stop_strings)
        for s in stops:
            if not isinstance(s, str) or s == "":
                raise ValueError(
                    f"stop_strings entries must be non-empty strings, "
                    f"got {s!r}")
        set_(self, "stop_strings", stops)
        if self.max_new_tokens is not None:
            mnt = int(self.max_new_tokens)
            if mnt < 1:
                raise ValueError(f"max_new_tokens must be >= 1, "
                                 f"got {self.max_new_tokens!r}")
            set_(self, "max_new_tokens", mnt)

    # ---- derived flags the slot buffers key their fast paths on -------
    @property
    def is_greedy(self):
        """True = this request takes the argmax path (no PRNG draw)."""
        return self.temperature == 0.0

    @property
    def uses_penalties(self):
        """True = the [B, V] token-count buffer must be maintained."""
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


GREEDY = SamplingParams()
