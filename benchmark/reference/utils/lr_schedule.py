"""Learning-rate schedules: own copy of `xmask3d_tpu/utils/lr_schedule.py`,
pure functions of the global step."""

from __future__ import annotations

import math


def poly_lr(base_lr: float, curr_iter: int, max_iter: int, power: float = 0.9) -> float:
    return base_lr * (1 - curr_iter / max_iter) ** power


def cosine_lr(base_lr: float, curr_iter: int, max_iter: int) -> float:
    return base_lr * 0.5 * (1 + math.cos(math.pi * curr_iter / max_iter))
