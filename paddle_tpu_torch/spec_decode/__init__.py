"""Speculative decoding for the paged serving engine: the port of
`paddle_tpu.spec_decode` (pure host Python and numpy, copied and adapted).

* `config` — `SpecConfig`, the eagerly validated speculation knobs
  (draft budget K, drafter choice, n-gram match window);
* `drafter` — the `Drafter` protocol, the self-drafting `NgramDrafter`
  (per-slot suffix lookup over the request's own prompt + generated
  tokens, no second model) and the `DraftModelDrafter` seam for a small
  draft model sharing the target tokenizer;
* `verifier` — host-side assembly of the packed verification plan; the
  verification itself runs on the device (`nn.decode.packed_verify`
  scores every slot's drafts in ONE dispatch and decides acceptance with
  the per-slot sampling pipeline plain decode runs).

The PRNG is counter-based (`fold_in(seed, step)`), so the target's token
at every position is deterministic given its logits: rejection sampling
reduces to exact match, and fixed-seed output is token-identical to
non-speculative decode whatever was accepted. Rejected draft positions
roll the paged cache back through `PagedKVCache.truncate_seq`.
"""
from .config import SpecConfig  # noqa: F401
from .drafter import Drafter, DraftModelDrafter, NgramDrafter  # noqa: F401
from .verifier import VerifyPlan, build_verify_plan  # noqa: F401

__all__ = ["SpecConfig", "Drafter", "NgramDrafter", "DraftModelDrafter",
           "VerifyPlan", "build_verify_plan"]
