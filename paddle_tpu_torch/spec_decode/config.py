"""Speculation configuration with EAGER validation: the port of
`paddle_tpu.spec_decode.config`.

`SpecConfig` follows the `SamplingParams` rule: a bad value raises a
ValueError that NAMES the offending field and value at construction
time, never as a shape failure inside a verify dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for `PagedGenerationServer`.

    max_draft_tokens: the draft budget K — each eligible slot proposes
        up to K tokens per scheduler round; one packed verification
        dispatch scores all proposals and emits between 1 and K+1
        tokens per slot (1 = first draft rejected, exactly what plain
        decode would have emitted; K+1 = all accepted plus the bonus
        token).
    drafter: "ngram" (the default self-drafting prompt-lookup drafter —
        no second model) or any object implementing the
        `drafter.Drafter` protocol (e.g. a `DraftModelDrafter` wrapping
        a small model that shares the target tokenizer).
    ngram_max_match / ngram_min_match: the n-gram drafter's suffix
        match window — it tries the longest suffix first and falls back
        down to min_match before giving up (no proposal = the slot
        takes plain decode this round).
    """

    max_draft_tokens: int = 4
    drafter: object = "ngram"
    ngram_max_match: int = 3
    ngram_min_match: int = 1

    def __post_init__(self):
        for name in ("max_draft_tokens", "ngram_max_match",
                     "ngram_min_match"):
            v = getattr(self, name)
            try:
                iv = int(v)
                if iv != v or iv < 1:
                    raise ValueError
            except (TypeError, ValueError):
                raise ValueError(
                    f"{name} must be an int >= 1, got {v!r}") from None
            object.__setattr__(self, name, iv)
        if self.ngram_min_match > self.ngram_max_match:
            raise ValueError(
                f"ngram_min_match ({self.ngram_min_match}) must be <= "
                f"ngram_max_match ({self.ngram_max_match})")
        if isinstance(self.drafter, str):
            if self.drafter != "ngram":
                raise ValueError(
                    f"drafter must be 'ngram' or a Drafter instance, "
                    f"got {self.drafter!r}")
        elif not callable(getattr(self.drafter, "propose", None)):
            raise ValueError(
                f"drafter must be 'ngram' or implement propose(); "
                f"got {self.drafter!r}")

    def make_drafter(self):
        """Instantiate the configured drafter (a fresh NgramDrafter for
        the string form; the instance itself otherwise)."""
        if isinstance(self.drafter, str):
            from .drafter import NgramDrafter

            return NgramDrafter(max_match=self.ngram_max_match,
                                min_match=self.ngram_min_match)
        return self.drafter
