"""Per-request sampling for the serving path (greedy subset).

* `params` — `SamplingParams`, the eagerly-validated per-request knob
  bundle (a copy of the reference's);
* `processors` — greedy readout (`sample_tokens`), the device stop-token
  check and the count scatter;
* `buffers` — `SlotParamStore`, per-slot params and stop-id matrices.

Sampled decoding and penalties come with a later slice of the port.
"""
from .buffers import SlotParamStore, check_greedy, greedy_args  # noqa: F401
from .params import GREEDY, SamplingParams  # noqa: F401

__all__ = ["SamplingParams", "GREEDY", "SlotParamStore", "greedy_args",
           "check_greedy"]
