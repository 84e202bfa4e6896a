"""Per-request sampling for the serving path (the port of
`paddle_tpu.sampling`).

* `params` — `SamplingParams`, the eagerly validated per-request knob
  bundle (temperature / top-k / top-p / min-p, penalties, seed, stop
  conditions, token budget; a copy of the reference's);
* `prng` — the reference's threefry2x32 streams in PyTorch, bit for bit;
* `processors` — vectorised `([R, V] logits, per-row tensors) -> [R, V]`
  logit processors and the composed `sample_tokens`, so ONE dispatch
  serves a batch mixing greedy and sampled requests;
* `buffers` — `SlotParamStore`, the per-slot struct-of-arrays buffers
  and the [slots, V] token-count buffer behind the penalties.
"""
from .buffers import GREEDY_MODE, SlotParamStore, greedy_args  # noqa: F401
from .params import GREEDY, SamplingParams  # noqa: F401

__all__ = ["SamplingParams", "GREEDY", "GREEDY_MODE", "SlotParamStore",
           "greedy_args"]
