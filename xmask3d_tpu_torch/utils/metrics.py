"""Segmentation metrics: own copy of `xmask3d_tpu/utils/metrics.py`
(`AverageMeter`, `intersection_and_union`, `miou_from_histograms`, `hiou`)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class AverageMeter:
    """Running average of host-side scalars."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)


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


def miou_from_histograms(inter: np.ndarray, union: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    return np.asarray(inter) / (np.asarray(union) + eps)


def hiou(miou_base: float, miou_novel: float, eps: float = 1e-10) -> float:
    """Harmonic mean of base and novel mIoU (the headline XMask3D metric)."""
    return 2 * miou_base * miou_novel / (miou_base + miou_novel + eps)
