"""Unique names: the port of `paddle_tpu/core/unique_name.py` (itself
python/paddle/fluid/unique_name.py): `generate(key)` gives "key_0",
"key_1", ... under the current `guard` prefix."""
from __future__ import annotations

import contextlib
from collections import defaultdict

_counters = defaultdict(int)
_prefix = []


def generate(key: str) -> str:
    _counters[key] += 1
    name = f"{key}_{_counters[key] - 1}"
    return "/".join(_prefix + [name]) if _prefix else name


@contextlib.contextmanager
def guard(new_prefix=None):
    """Fresh counters (and an optional name prefix) inside the block."""
    global _counters
    old = _counters
    _counters = defaultdict(int)
    if new_prefix:
        _prefix.append(new_prefix.rstrip("/"))
    try:
        yield
    finally:
        _counters = old
        if new_prefix:
            _prefix.pop()


def switch():
    global _counters
    _counters = defaultdict(int)


__all__ = ["generate", "guard", "switch"]
