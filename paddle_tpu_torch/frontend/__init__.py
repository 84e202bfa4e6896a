"""Serving front door: the port's copy of `paddle_tpu.frontend`.

Token streaming, SLO-aware
scheduling (interactive/batch lanes, TTFT deadlines), preemption with
prefix-cache swap-out, and multi-tenant fairness (weighted fair share,
token-rate limits, bounded queues with explicit rejection) — the
scheduling-and-delivery layer over `inference.PagedGenerationServer`.
Pure host Python: nothing here launches a kernel.
"""
from ..inference.serving import RequestMeta
from .frontdoor import FrontDoor
from .scheduler import LANES, LaneScheduler
from .stream import DeltaAssembler, StreamEvent, StreamHandle
from .tenancy import QueueFull, TenantConfig, TokenBucket

__all__ = [
    "FrontDoor", "LaneScheduler", "LANES", "RequestMeta",
    "DeltaAssembler", "StreamEvent", "StreamHandle",
    "QueueFull", "TenantConfig", "TokenBucket",
]
