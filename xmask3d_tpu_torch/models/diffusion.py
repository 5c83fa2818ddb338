"""Gaussian diffusion schedules, respacing and the DDIM / DDPM samplers.

Counterpart of `xmask3d_tpu/models/diffusion.py`. The schedule is float64
numpy, as in the JAX module; the loops keep their state in fp32 on the
model's device and draw their noise from an explicit `torch.Generator`.
The eval path uses only the schedule and `q_sample` (SD's `ldm_linear`
betas, features taken at t = 0).

Respacing keeps guided-diffusion's `timestep_map` (`respace.py`,
`_WrappedModel`): the samplers step through the respaced indices [0, n) but
hand the model the original timestep each index stands for, the one its
time embedding was trained on. The JAX loops hand the model the respaced
index itself (ROADMAP C 11); without respacing the map is the identity and
the two agree.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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
    if schedule == "cosine":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        return np.array([min(1 - alpha_bar((i + 1) / steps) / alpha_bar(i / steps), 0.999)
                         for i in range(steps)], dtype=np.float64)
    raise ValueError(f"unknown beta schedule {schedule}")


def space_timesteps(num_timesteps: int, section_counts) -> Sequence[int]:
    """The timesteps kept by respacing: "ddimN" (a uniform stride giving
    exactly N steps), or counts per equal section ("10,15,20" or a list)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return all_steps


# pre-drawn noise for a loop: the initial x_T and one draw a step, in step order
Noise = Tuple[torch.Tensor, Sequence[torch.Tensor]]


class GaussianDiffusion:
    """Immutable schedule (host numpy), optionally respaced."""

    def __init__(self, steps: int = 1000, noise_schedule: str = "ldm_linear",
                 timestep_respacing: Optional[str] = None):
        self.schedule = (noise_schedule, steps, timestep_respacing)
        betas = make_betas(noise_schedule, steps)
        used = np.arange(steps)
        if timestep_respacing:
            used = np.array(sorted(space_timesteps(steps, timestep_respacing)))
            alphas_cum = np.cumprod(1.0 - betas)
            last, new_betas = 1.0, []
            for t in used:
                new_betas.append(1 - alphas_cum[t] / last)
                last = alphas_cum[t]
            betas = np.array(new_betas)
        self.betas = betas
        self.timestep_map = used.astype(np.int64)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    @classmethod
    def create(cls, steps: int = 1000, noise_schedule: str = "ldm_linear",
               timestep_respacing: Optional[str] = None) -> "GaussianDiffusion":
        return cls(steps, noise_schedule, timestep_respacing)

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def _table(self, name: str, values: np.ndarray, dtype, device) -> torch.Tensor:
        return device_constant((name, self.schedule, dtype), device,
                               lambda: torch.as_tensor(values, dtype=dtype))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Diffuse x_start to timestep t."""
        a = self._table("alphas_cumprod", self.alphas_cumprod, x_start.dtype,
                        x_start.device)[t.long()]
        shape = (-1,) + (1,) * (x_start.ndim - 1)
        return torch.sqrt(a).reshape(shape) * x_start + torch.sqrt(1.0 - a).reshape(shape) * noise

    def eps_to_xstart(self, x_t: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        a = self._table("alphas_cumprod", self.alphas_cumprod, x_t.dtype, x_t.device)[t.long()]
        shape = (-1,) + (1,) * (x_t.ndim - 1)
        return (x_t - torch.sqrt(1.0 - a).reshape(shape) * eps) / torch.sqrt(a).reshape(shape)

    def _loop(self, model: Callable, shape, generator, device, noise: Optional[Noise],
              model_kwargs, update: Callable):
        """The shared sampler loop: x_T, then for t = n-1 .. 0 the model's
        eps at the original timestep of index t, and x = `update(x, eps,
        tb, t, draw)`, where tb is t for every row and `draw()` gives the
        step's noise."""
        if noise is None:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        else:
            x = noise[0].to(device=device, dtype=torch.float32)
        model_kwargs = model_kwargs or {}
        tmap = self._table("timestep_map", self.timestep_map, torch.int64, x.device)
        n = self.num_timesteps
        for i in range(n):
            t = n - 1 - i
            tb = torch.full((shape[0],), t, dtype=torch.int64, device=x.device)
            eps = model(x, tmap[tb], **model_kwargs).float()

            def draw(i=i):
                if noise is not None:
                    return noise[1][i].to(device=x.device, dtype=torch.float32)
                return torch.randn(shape, generator=generator, device=x.device,
                                   dtype=torch.float32)

            x = update(x, eps, tb, t, draw)
        return x

    def ddim_sample_loop(self, model: Callable, shape, generator: Optional[torch.Generator] = None,
                         eta: float = 0.0, clip_denoised: bool = False,
                         model_kwargs: Optional[dict] = None, device=None,
                         noise: Optional[Noise] = None) -> torch.Tensor:
        """DDIM sampling. `model(x, t, **model_kwargs)` predicts eps; x_T
        and each step's noise come from `generator` on `device`, or from
        `noise` (x_T and one draw a step). At eta 0 no step draws noise:
        its weight is 0."""
        ac = np.concatenate([[1.0], self.alphas_cumprod]).astype(np.float32)
        eta = np.float32(eta)
        one = np.float32(1.0)

        def update(x, eps, tb, t, draw):
            x0 = self.eps_to_xstart(x, tb, eps)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            a_t, a_prev = ac[t + 1], ac[t]
            sigma = eta * np.sqrt((one - a_prev) / (one - a_t)) * np.sqrt(one - a_t / a_prev)
            c_eps = np.sqrt(np.maximum(one - a_prev - sigma ** 2, np.float32(0.0)))
            out = float(np.sqrt(a_prev)) * x0 + float(c_eps) * eps
            return out + float(sigma) * draw() if sigma > 0 else out

        return self._loop(model, shape, generator, device, noise, model_kwargs, update)

    def p_sample_loop(self, model: Callable, shape, generator: Optional[torch.Generator] = None,
                      clip_denoised: bool = False, model_kwargs: Optional[dict] = None,
                      device=None, noise: Optional[Noise] = None) -> torch.Tensor:
        """Ancestral DDPM sampling; arguments as `ddim_sample_loop`. The
        last step (t = 0) returns the predicted x0 and draws nothing."""
        betas = self.betas.astype(np.float32)
        ac = self.alphas_cumprod.astype(np.float32)
        ac_prev = np.concatenate([[np.float32(1.0)], ac[:-1]]).astype(np.float32)
        one = np.float32(1.0)

        def update(x, eps, tb, t, draw):
            x0 = self.eps_to_xstart(x, tb, eps)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            if t == 0:
                return x0
            c0 = np.sqrt(ac_prev[t]) * betas[t] / (one - ac[t])
            ct = np.sqrt(one - betas[t]) * (one - ac_prev[t]) / (one - ac[t])
            var = betas[t] * (one - ac_prev[t]) / (one - ac[t])
            return (float(c0) * x0 + float(ct) * x) + float(np.sqrt(var)) * draw()

        return self._loop(model, shape, generator, device, noise, model_kwargs, update)
