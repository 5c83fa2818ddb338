"""2D -> 3D mask painting and feature fusion as batched ops.

Counterpart of the eval parts of `xmask3d_tpu/losses/fuser.py`: each mask
paints its embedding onto its projected points (fp32 accumulation,
count-normalised), then a Linear(2C -> C) fuses it with the 3D feature.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn


class FeatureMerger(nn.Module):
    """concat + Linear fusion head."""

    def __init__(self, feature_dim: int = 768):
        super().__init__()
        self.linear = nn.Linear(2 * feature_dim, feature_dim)

    def forward(self, feat_2d, feat_3d):
        return self.linear(torch.cat([feat_2d, feat_3d], dim=-1))


def project_masks_to_points(masks: torch.Tensor, x_label: torch.Tensor,
                            y_label: torch.Tensor) -> torch.Tensor:
    """Gather mask values (B, Q, Hm, Wm) at point pixels (row x, col y) ->
    (B, Q, P)."""
    b, q, hm, wm = masks.shape
    idx = x_label.long().clamp(0, hm - 1) * wm + y_label.long().clamp(0, wm - 1)
    return torch.gather(masks.reshape(b, q, hm * wm), 2, idx[:, None, :].expand(b, q, -1))


def paint_and_fuse(
    mask_3d: torch.Tensor,  # (B, Q, P) bool
    q_valid: torch.Tensor,  # (B, Q) bool
    mask_embeds: torch.Tensor,  # (B, Q, C)
    pred_3d: torch.Tensor,  # (B, P, C)
    point_valid: torch.Tensor,  # (B, P)
    fuser: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Returns fused (B, P, C), feat_2d (B, P, C), counter (B, P) and
    covered (B, P) = counter >= 1."""
    m = (mask_3d & q_valid[:, :, None] & point_valid[:, None, :]).float()
    # a scene with zero covered points paints query 0 on point 0
    empty = m.sum(dim=(1, 2)) == 0
    m[:, 0, 0] = torch.where(empty, torch.ones_like(m[:, 0, 0]), m[:, 0, 0])
    painted = torch.einsum("bqp,bqc->bpc", m, mask_embeds.float())
    counter = m.sum(dim=1)
    feat_2d = (painted / torch.clamp(counter[..., None], min=1e-5)).to(pred_3d.dtype)
    covered = counter >= 1.0
    fused = torch.where(covered[..., None], fuser(feat_2d, pred_3d), pred_3d)
    return {"fused": fused, "feat_2d": feat_2d, "counter": counter, "covered": covered}


def panoptic_mask_filter(
    scores: torch.Tensor,  # (B, Q)
    masks: torch.Tensor,  # (B, Q, H, W) logits
    keep: torch.Tensor,  # (B, Q) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pixel is claimed by the query maximising score * sigmoid(mask)
    (first index on ties); a query survives if it claims a pixel that also
    passes its own 0.5 threshold. Returns (final masks (B, Q, H, W) bool,
    final_valid (B, Q) bool)."""
    sig = torch.sigmoid(masks)
    prob = scores[:, :, None, None] * sig
    prob = torch.where(keep[:, :, None, None], prob, torch.full((), -1e30, dtype=prob.dtype, device=prob.device))
    claim = prob.argmax(dim=1)  # first index on ties, as jnp.argmax
    q_ids = torch.arange(masks.shape[1], device=masks.device)[None, :, None, None]
    final = (claim[:, None] == q_ids) & (sig >= 0.5) & keep[:, :, None, None]
    orig_area = (sig >= 0.5).sum(dim=(-1, -2))
    final_valid = (final.sum(dim=(-1, -2)) > 0) & (orig_area > 0) & keep
    return final & final_valid[:, :, None, None], final_valid
