"""hapi logger setup: `setup_logger` configures the `paddle_tpu_torch.hapi`
logger of the progress callbacks — a stdout handler, and a file handler
under `output` when given."""
from __future__ import annotations

import logging
import sys


def setup_logger(output=None, name="paddle_tpu_torch.hapi", log_level=logging.INFO):
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(log_level)
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        h = logging.StreamHandler(stream=sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if output is not None:
        fname = output if output.endswith((".txt", ".log")) \
            else output + "/log.txt"
        import os
        os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
        # re-entrant setup must not duplicate file sinks
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None)
                   == os.path.abspath(fname) for h in logger.handlers):
            fh = logging.FileHandler(fname)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
