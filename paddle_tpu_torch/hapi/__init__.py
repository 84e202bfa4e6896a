"""paddle.hapi of the port: `Model` (fit / evaluate / predict / save /
load), `callbacks`, `flops`, `summary`, the progress bar and the
logger setup."""
from __future__ import annotations

from . import callbacks  # noqa: F401
from . import logger  # noqa: F401
from . import model_summary  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401
from .static_flops import flops  # noqa: F401

__all__ = ["Model", "callbacks", "logger", "model_summary", "summary",
           "flops"]
