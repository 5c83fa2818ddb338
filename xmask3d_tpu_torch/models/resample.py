"""Timestep samplers for diffusion training: the port's own copy of
`xmask3d_tpu/models/resample.py` (host numpy).

`UniformSampler` draws timesteps uniformly; `LossSecondMomentResampler`
draws them in proportion to sqrt(E[loss^2]) of each timestep's last
`history_per_term` losses, mixed with `uniform_prob` of the uniform
distribution, once every timestep has a full history. `sample` returns the
timesteps and their importance weights 1 / (n p[t]).
"""

from __future__ import annotations

import numpy as np


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def weights(self) -> np.ndarray:
        return np.ones((self.num_timesteps,), np.float64)

    def sample(self, batch_size: int, rng: np.random.RandomState):
        w = self.weights()
        p = w / w.sum()
        t = rng.choice(self.num_timesteps, size=(batch_size,), p=p)
        weights = 1.0 / (self.num_timesteps * p[t])
        return t.astype(np.int32), weights.astype(np.float32)


class LossSecondMomentResampler(UniformSampler):
    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        super().__init__(num_timesteps)
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._loss_counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / len(w)

    def update_with_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        """Append each (timestep, loss) pair to that timestep's history,
        dropping its oldest loss once the history is full."""
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1
