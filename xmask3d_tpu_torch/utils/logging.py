"""Logging: own copy of `xmask3d_tpu/utils/logging.py` (`get_logger`, and
`MetricsWriter`: scalars to a JSONL file, mirrored to tensorboardX when
that package is installed)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict


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


class MetricsWriter:
    """JSONL scalar writer (`<save_path>/metrics.jsonl`, one object a
    scalar) with an optional tensorboardX mirror."""

    def __init__(self, save_path: str):
        os.makedirs(save_path, exist_ok=True)
        self.path = os.path.join(save_path, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(save_path)
        except ImportError:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in metrics.items():
            self.add_scalar(prefix + k, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
