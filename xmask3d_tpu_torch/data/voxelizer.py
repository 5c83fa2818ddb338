"""Host-side voxelization (numpy): own copy of `xmask3d_tpu/data/voxelizer.py`
for the un-augmented eval path (sparse quantization into a voxel grid)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BITS = 20


def _pack_nonneg(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64)
    return (c[:, 0] << (2 * _BITS)) | (c[:, 1] << _BITS) | c[:, 2]


def sparse_quantize(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate integer coords -> (inds, inds_reconstruct): one
    representative point per voxel in packed-key order, and each point's
    voxel row."""
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (N, 3), got {coords.shape}")
    c = coords.astype(np.int64)
    c = c - c.min(0)
    _, inds, inds_reverse = np.unique(
        _pack_nonneg(c), return_index=True, return_inverse=True
    )
    return inds, inds_reverse


class Voxelizer:
    """Quantization to a voxel grid of `voxel_size` (no augmentation)."""

    def __init__(self, voxel_size: float = 0.05):
        self.voxel_size = voxel_size

    def voxelize(self, coords, feats, labels):
        """Returns (voxel_coords int32, voxel_feats, voxel_labels,
        inds_reconstruct int64). Voxels come out in lexicographic (x, y, z)
        order, which keeps kernel maps band-local."""
        if coords.shape[1] != 3 or coords.shape[0] != feats.shape[0]:
            raise ValueError("coords must be (N, 3) and match feats")
        m_v = np.eye(4)
        np.fill_diagonal(m_v[:3, :3], 1 / self.voxel_size)
        homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
        coords_aug = np.floor(homo @ m_v.T[:, :3])
        coords_aug = np.floor(coords_aug - coords_aug.min(0))
        inds, inds_reconstruct = sparse_quantize(coords_aug)
        labels_out = labels[inds] if labels is not None else None
        return (
            coords_aug[inds].astype(np.int32), feats[inds], labels_out,
            inds_reconstruct.astype(np.int64),
        )
