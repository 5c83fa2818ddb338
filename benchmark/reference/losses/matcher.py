"""Hungarian matcher with point-sampled mask costs.

Counterpart of `xmask3d_tpu/losses/matcher.py`: per image, cost =
cost_class * (-prob) + cost_mask * pairwise sigmoid-CE + cost_dice *
pairwise dice on one shared set of sampled points. Targets are padded to T
with a validity mask; padded rows keep a uniform cost of 0, so they take
leftover queries without moving the valid rows' assignment.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.point_sample import dice_loss_pairwise, point_sample, sigmoid_ce_pairwise


@torch.no_grad()
def match_costs(
    pred_logits: torch.Tensor,  # (B, Q, C + 1)
    pred_masks: torch.Tensor,  # (B, Q, H, W) logits
    target_labels: torch.Tensor,  # (B, T) int, -1 pad
    target_masks: torch.Tensor,  # (B, T, Ht, Wt) float 0/1
    target_valid: torch.Tensor,  # (B, T) bool
    coords: torch.Tensor,  # (B, N, 2) uniform draws
    cost_class: float = 2.0,
    cost_mask: float = 5.0,
    cost_dice: float = 5.0,
) -> torch.Tensor:
    """The matcher's (B, T, Q) cost matrices (targets as rows)."""
    pred_pts = point_sample(pred_masks, coords)  # (B, Q, N)
    tgt_pts = point_sample(target_masks, coords)  # (B, T, N)
    prob = torch.softmax(pred_logits.float(), dim=-1)
    b, q = prob.shape[:2]
    safe = target_labels.long().clamp(0, pred_logits.shape[-1] - 1)
    c_class = -torch.gather(prob, 2, safe[:, None, :].expand(b, q, -1))  # (B, Q, T)
    cost = cost_class * c_class + cost_mask * sigmoid_ce_pairwise(pred_pts, tgt_pts) \
        + cost_dice * dice_loss_pairwise(pred_pts, tgt_pts)
    cost = torch.where(target_valid[:, None, :], cost, torch.zeros((), device=cost.device))
    return cost.transpose(1, 2)
