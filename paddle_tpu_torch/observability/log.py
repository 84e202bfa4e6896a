"""Library logger with env-var verbosity: the port's copy of
`paddle_tpu.observability.log`, rooted at `paddle_tpu_torch`.

Library code does not `print()`: diagnostics go through
`paddle_tpu_torch.observability.log.get_logger`, whose
verbosity is controlled by the PADDLE_TPU_LOG_LEVEL environment variable
(debug | info | warning | error, or a numeric logging level; default
info so existing user-visible diagnostics keep appearing). Messages go
to stderr so they never pollute machine-parsed stdout (bench JSON
lines).

    from paddle_tpu_torch.observability import log
    logger = log.get_logger(__name__)
    logger.info("trace written to %s", path)
"""
from __future__ import annotations

import logging
import os
import sys

ENV_LEVEL = "PADDLE_TPU_LOG_LEVEL"
_ROOT = "paddle_tpu_torch"
_configured = False


def _level_from_env(default=logging.INFO):
    raw = os.environ.get(ENV_LEVEL, "").strip()
    if not raw:
        return default
    if raw.isdigit():
        return int(raw)
    return {
        "debug": logging.DEBUG, "info": logging.INFO,
        "warning": logging.WARNING, "warn": logging.WARNING,
        "error": logging.ERROR, "critical": logging.CRITICAL,
        "off": logging.CRITICAL + 10, "none": logging.CRITICAL + 10,
    }.get(raw.lower(), default)


def _configure_root():
    global _configured
    root = logging.getLogger(_ROOT)
    if _configured:
        return root
    root.setLevel(_level_from_env())
    root.propagate = False  # the app's root logger must not double-print
    if not root.handlers:
        h = logging.StreamHandler(stream=sys.stderr)
        h.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(h)
    _configured = True
    return root


def get_logger(name=None):
    """A logger under the `paddle_tpu_torch` root (configured once: stderr
    handler, level from PADDLE_TPU_LOG_LEVEL). `name` may be a module
    __name__ — anything outside the paddle_tpu_torch.* namespace is nested
    under it so the root handler/level always applies."""
    _configure_root()
    if not name or name == _ROOT:
        return logging.getLogger(_ROOT)
    if not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def set_level(level):
    """Programmatic override of the env-var verbosity (accepts logging
    constants or the same strings as PADDLE_TPU_LOG_LEVEL)."""
    if isinstance(level, str):
        os.environ[ENV_LEVEL] = level
        level = _level_from_env()
    _configure_root().setLevel(level)


logger = get_logger()
