"""Host-side voxelization (numpy): own copy of the eval path of
`xmask3d_tpu/data/voxelizer.py`.

Sparse quantization into a voxel grid. Dedup uses exact int64 bit-packing
of the integer coordinates. The training-time rotation, scale, translation
and clipping come with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BITS = 20


def _pack_nonneg(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64)
    return (c[:, 0] << (2 * _BITS)) | (c[:, 1] << _BITS) | c[:, 2]


def sparse_quantize(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate integer coords.

    Returns (inds, inds_reconstruct): `inds` selects one representative point
    per voxel (first occurrence in np.unique key order, matching the
    reference's np.unique(key) at voxelization_utils.py:95), and
    `inds_reconstruct` maps each point to its voxel row.
    """
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (N, 3), got {coords.shape}")
    c = coords.astype(np.int64)
    c = c - c.min(0)  # ensure non-negative for packing
    key = _pack_nonneg(c)
    _, inds, inds_reverse = np.unique(key, return_index=True, return_inverse=True)
    return inds, inds_reverse


class Voxelizer:
    """Quantization of a point cloud to a voxel grid of `voxel_size`."""

    def __init__(self, voxel_size: float = 0.05):
        self.voxel_size = voxel_size

    def voxelize(self, coords, feats, labels):
        """Returns (voxel_coords int, voxel_feats, voxel_labels,
        inds_reconstruct): the reference voxelize contract
        (voxelizer.py:81-132) without augmentation."""
        if coords.shape[1] != 3 or coords.shape[0] != feats.shape[0]:
            raise ValueError("coords must be (N, 3) and match feats")
        scale = np.eye(4)
        np.fill_diagonal(scale[:3, :3], 1 / self.voxel_size)
        homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
        coords_aug = np.floor(homo @ scale.T[:, :3])
        coords_aug = np.floor(coords_aug - coords_aug.min(0))

        inds, inds_reconstruct = sparse_quantize(coords_aug)
        # np.unique over the packed key leaves voxels in lexicographic
        # (x, y, z) order, which keeps kernel maps band-local
        coords_out = coords_aug[inds].astype(np.int32)
        labels_out = labels[inds] if labels is not None else None
        return coords_out, feats[inds], labels_out, inds_reconstruct.astype(np.int64)
