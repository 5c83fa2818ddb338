"""Optimal assignment of the matcher's (T, Q) costs, solved on the host.

Counterpart of `xmask3d_tpu/ops/hungarian.py`, whose jit-able solver gives
scipy's optimal cost (ties may be broken differently). The port copies a
step's cost matrices, all layers and samples at once, to the host in one
transfer and solves each with `scipy.optimize.linear_sum_assignment`, the
reference's own solver. Non-finite costs are first made large finite ones,
as the JAX package does, so a diverged step reports a NaN loss instead of
raising. The copy (the training step's one synchronisation), the
solves and the copy back are the `xm3d.matcher` span (`utils/spans.py`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment as _scipy_lsa

from xmask3d_tpu_torch.utils.spans import span


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """cost (..., T, Q) with T <= Q -> (..., T) int64 on cost's device: the
    column assigned to every row of each matrix."""
    *lead, t, q = cost.shape
    if t > q:
        raise ValueError(f"linear_sum_assignment: {t} rows > {q} columns")
    with span("xm3d.matcher"):
        host = np.nan_to_num(cost.detach().float().cpu().numpy().reshape(-1, t, q),
                             nan=1e9, posinf=1e9, neginf=-1e9)
        cols = np.empty((host.shape[0], t), np.int64)
        for i, c in enumerate(host):
            rows, col = _scipy_lsa(c)
            cols[i, rows] = col
        return torch.from_numpy(cols.reshape(*lead, t)).to(cost.device)
