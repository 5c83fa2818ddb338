"""Segmentation metrics: the training forward's IoU histograms."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def intersection_and_union(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                           ignore_index: Sequence[int] = (255,),
                           valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (intersection, union, target) fp32 histograms of shape
    (num_classes,) on the device of `pred`. Positions whose target is an
    ignore index, or that `valid` marks padded, count nowhere; a value
    outside [0, num_classes) adds to no bin (as the JAX package's one-hot
    sums)."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    keep = torch.ones_like(target, dtype=torch.bool)
    for ig in ignore_index:
        keep &= target != ig
    if valid is not None:
        keep &= valid.reshape(-1)

    def hist(x, mask):
        inside = mask & (x >= 0) & (x < num_classes)
        bins = torch.where(inside, x, torch.full_like(x, num_classes))
        out = torch.zeros(num_classes + 1, dtype=torch.float32, device=x.device)
        return out.index_add_(0, bins, inside.float())[:num_classes]

    inter = hist(pred, keep & (pred == target))
    area_pred = hist(pred, keep)
    area_target = hist(target, keep)
    return inter, area_pred + area_target - inter, area_target
