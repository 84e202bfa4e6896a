"""paddle.reader.decorator module path (ref: reader/decorator.py) — the
1.x reader combinators live in the package __init__; this module is the
import-path twin the reference also exposes."""
from . import (  # noqa: F401
    batch, buffered, cache, chain, compose, ComposeNotAligned, firstn,
    map_readers, multiprocess_reader, shuffle, xmap_readers,
)

__all__ = ["cache", "map_readers", "buffered", "shuffle", "chain",
           "ComposeNotAligned", "firstn", "xmap_readers",
           "multiprocess_reader", "compose"]
