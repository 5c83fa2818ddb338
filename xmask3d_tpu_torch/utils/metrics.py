"""Segmentation metrics: own copy of `hiou` from `xmask3d_tpu/utils/metrics.py`."""

from __future__ import annotations


def hiou(miou_base: float, miou_novel: float, eps: float = 1e-10) -> float:
    """Harmonic mean of base and novel mIoU (the headline XMask3D metric)."""
    return 2 * miou_base * miou_novel / (miou_base + miou_novel + eps)
