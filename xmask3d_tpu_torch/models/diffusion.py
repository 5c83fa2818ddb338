"""Gaussian diffusion schedule and `q_sample`: the part of
`xmask3d_tpu/models/diffusion.py` the eval path uses (SD's `ldm_linear`
betas; features are taken at t = 0)."""

from __future__ import annotations

import numpy as np
import torch

from xmask3d_tpu_torch.device import device_constant


def make_betas(schedule: str, steps: int) -> np.ndarray:
    scale = 1000 / steps
    if schedule == "linear":
        return np.linspace(scale * 1e-4, scale * 0.02, steps, dtype=np.float64)
    if schedule == "ldm_linear":
        return np.linspace((scale * 0.00085) ** 0.5, (scale * 0.012) ** 0.5, steps,
                           dtype=np.float64) ** 2
    raise ValueError(f"unknown beta schedule {schedule}")


class GaussianDiffusion:
    """Immutable schedule (host numpy)."""

    def __init__(self, steps: int = 1000, noise_schedule: str = "ldm_linear"):
        self.schedule = (noise_schedule, steps)
        self.betas = make_betas(noise_schedule, steps)
        self.alphas_cumprod = np.cumprod(1.0 - self.betas, axis=0)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Diffuse x_start to timestep t."""
        dt = x_start.dtype
        ac = device_constant(("alphas_cumprod", self.schedule, dt),
                             x_start.device, lambda: torch.as_tensor(self.alphas_cumprod, dtype=dt))
        shape = (-1,) + (1,) * (x_start.ndim - 1)
        a = ac[t.long()]
        return torch.sqrt(a).reshape(shape) * x_start + torch.sqrt(1.0 - a).reshape(shape) * noise
