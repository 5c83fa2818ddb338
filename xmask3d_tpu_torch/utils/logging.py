"""Logging: own copy of `get_logger` from `xmask3d_tpu/utils/logging.py`."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "xmask3d_tpu_torch") -> logging.Logger:
    """A stderr logger at INFO, configured once per name."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        fmt = "[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
