"""Point sampling and point-sampled mask costs for the mask losses.

Counterpart of `xmask3d_tpu/ops/point_sample.py`. Bilinear sampling has
grid_sample align_corners=False semantics (pixel = coord * size - 0.5, zero
padding). The random coordinates are inputs: `point_draws` makes all of a
training step's draws up front from one `torch.Generator`, so the same step
can be fed the JAX package's draws.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (B, Q, H, W) mask logits at (B, N, 2) normalised xy coords ->
    (B, Q, N), with the four taps weighted in the JAX package's order."""
    b, q, h, w = masks.shape
    n = coords.shape[1]
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0)[:, None], (y - y0)[:, None]
    flat = masks.reshape(b, q, h * w)

    def tap(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
        v = torch.gather(flat, 2, idx[:, None, :].expand(b, q, n))
        return torch.where(inb[:, None, :], v, torch.zeros((), dtype=v.dtype, device=v.device))

    top = tap(x0, y0) * (1 - dx) + tap(x0 + 1, y0) * dx
    bot = tap(x0, y0 + 1) * (1 - dx) + tap(x0 + 1, y0 + 1) * dx
    return top * (1 - dy) + bot * dy


def uncertainty_sampled_points(mask_logits: torch.Tensor, over: torch.Tensor,
                               refill: torch.Tensor, num_points: int,
                               importance_sample_ratio: float = 0.75) -> torch.Tensor:
    """Importance sampling by uncertainty -|logit|: of the oversampled
    coords `over` (B, N * k, 2) keep the int(ratio * num_points) most
    uncertain (measured on the per-query most certain logit), then the
    uniform `refill` coords (B, N - kept, 2). Returns (B, N, 2)."""
    n_unc = int(importance_sample_ratio * num_points)
    if refill.shape[1] != num_points - n_unc:
        raise ValueError(f"refill has {refill.shape[1]} points, expected {num_points - n_unc}")
    logits = point_sample(mask_logits, over)  # (B, Q, N * k)
    uncertainty = -logits.abs().amin(dim=1)
    idx = torch.topk(uncertainty, n_unc, dim=1).indices
    top = torch.gather(over, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([top, refill], dim=1)


def point_draws(generator: torch.Generator, n_layers: int, batch: int, targets: int,
                num_points: int, oversample_ratio: float = 3.0,
                importance_sample_ratio: float = 0.75, device=None) -> Dict[str, torch.Tensor]:
    """All uniform [0, 1) coordinates one training step needs, per
    prediction layer: the matcher's (B, N, 2), and the mask loss's
    oversampled (B * T, N * k, 2) and refill (B * T, N - kept, 2) ones."""
    n_sampled = int(num_points * oversample_ratio)
    n_rand = num_points - int(importance_sample_ratio * num_points)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {
        "matcher": uniform(n_layers, batch, num_points, 2),
        "over": uniform(n_layers, batch * targets, n_sampled, 2),
        "refill": uniform(n_layers, batch * targets, n_rand, 2),
    }


def dice_loss_pairwise(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Pairwise dice cost on sampled points: (..., Q, N), (..., T, N) -> (..., Q, T)."""
    p = torch.sigmoid(inputs)
    num = 2 * torch.einsum("...qn,...tn->...qt", p, targets)
    den = p.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1 - (num + 1) / (den + 1)


def sigmoid_ce_pairwise(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Pairwise mean sigmoid-CE cost: (..., Q, N), (..., T, N) -> (..., Q, T)."""
    n = inputs.shape[-1]
    pos = F.softplus(-inputs)  # CE for target 1
    neg = F.softplus(inputs)  # CE for target 0
    return (torch.einsum("...qn,...tn->...qt", pos, targets)
            + torch.einsum("...qn,...tn->...qt", neg, 1 - targets)) / n


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise-matched dice loss: (M, N) logits vs (M, N) {0, 1} -> (M,)."""
    p = torch.sigmoid(inputs)
    num = 2 * (p * targets).sum(-1)
    den = p.sum(-1) + targets.sum(-1)
    return 1 - (num + 1) / (den + 1)


def sigmoid_ce_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean per-point sigmoid CE: (M, N) -> (M,)."""
    return (F.softplus(inputs) - inputs * targets).mean(-1)
