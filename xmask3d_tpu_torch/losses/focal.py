"""Focal loss: own copy of `xmask3d_tpu/losses/focal.py` (declared by the
reference, unused on the training path)."""

from __future__ import annotations

import torch


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25, ignore_index: int = 255) -> torch.Tensor:
    keep = (labels != ignore_index).float()
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    pt = torch.exp(-ce)
    loss = alpha * (1 - pt) ** gamma * ce
    return (loss * keep).sum() / keep.sum().clamp(min=1.0)
