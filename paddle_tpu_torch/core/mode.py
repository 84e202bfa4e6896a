"""The execution mode: the port runs dygraph (eager) only, as the
reference does by default (`paddle_tpu/core/mode.py`). The static graph
(`enable_static`, `paddle.static`) is not ported yet (ROADMAP §A 14):
`enable_static` raises, naming that item."""
from __future__ import annotations


def enable_static():
    raise NotImplementedError(
        "paddle_tpu_torch runs dygraph only: the static graph "
        "(enable_static, paddle.static, jit.to_static) is ROADMAP §A 14, "
        "not ported yet")


def disable_static():
    return None


def in_dygraph_mode() -> bool:
    return True


__all__ = ["enable_static", "disable_static", "in_dygraph_mode"]
