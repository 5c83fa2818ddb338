"""Host-side voxelization (numpy): own copy of `xmask3d_tpu/data/voxelizer.py`.

Sparse quantization into a voxel grid, with the training-time rigid
augmentation of the reference's voxelizer.py:11-132 (a random rotation
about each axis in a shuffled order, then a scale) at the ScanNet
loader's bounds, and the optional clip box with its translation draws. Dedup uses exact int64 bit-packing of the integer
coordinates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BITS = 20

# the ScanNet loader's augmentation bounds (the JAX data/scannet.py)
SCALE_AUGMENTATION_BOUND = (0.9, 1.1)
ROTATION_AUGMENTATION_BOUND = (
    (-np.pi / 64, np.pi / 64),
    (-np.pi / 64, np.pi / 64),
    (-np.pi, np.pi),
)


def _rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about `axis` by `theta` (the reference's expm of
    the cross-product matrix, in closed form)."""
    a = axis / np.linalg.norm(axis)
    kx, ky, kz = a
    k = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


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
    """Quantization to a voxel grid of `voxel_size`; with `use_augmentation`,
    a random rotation and scale first, drawn from the RandomState a call
    passes in the JAX package's order: the three rotation angles, their
    shuffle, the scale.

    `clip_bound` ((lo, hi) per axis, around the points' box centre or a
    given `center`) keeps only the points inside the box, first, unless
    that would keep none; with augmentation and
    `translation_augmentation_ratio_bound` the centre moves by a drawn
    fraction of the box's size on each axis, drawn before the rotations. No
    loader passes a clip box (the JAX loader passes None)."""

    def __init__(self, voxel_size: float = 0.05, use_augmentation: bool = False,
                 clip_bound=None, translation_augmentation_ratio_bound=None):
        self.voxel_size = voxel_size
        self.use_augmentation = use_augmentation
        self.clip_bound = clip_bound
        self.translation_augmentation_ratio_bound = translation_augmentation_ratio_bound

    def _clip(self, coords: np.ndarray, center=None, trans_aug_ratio=None) -> np.ndarray:
        """(N,) bool: the points inside the clip box."""
        bound_min = coords.min(0).astype(float)
        bound_size = coords.max(0).astype(float) - bound_min
        if center is None:
            center = bound_min + bound_size * 0.5
        if trans_aug_ratio is not None:
            center = center + trans_aug_ratio * bound_size
        keep = np.ones(len(coords), bool)
        for ax, (lo, hi) in enumerate(self.clip_bound):
            keep &= (coords[:, ax] >= lo + center[ax]) & (coords[:, ax] < hi + center[ax])
        return keep

    def _rigid(self, rng: np.random.RandomState) -> np.ndarray:
        """The 4x4 map from points to voxel coords: the scale, and with
        augmentation a random one and a rotation after it."""
        voxelization_matrix = np.eye(4)
        scale = 1 / self.voxel_size
        if not self.use_augmentation:
            np.fill_diagonal(voxelization_matrix[:3, :3], scale)
            return voxelization_matrix
        mats = []
        for axis_ind, bound in enumerate(ROTATION_AUGMENTATION_BOUND):
            axis = np.zeros(3)
            axis[axis_ind] = 1
            mats.append(_rotation_matrix(axis, rng.uniform(*bound)))
        rng.shuffle(mats)
        rotation_matrix = np.eye(4)
        rotation_matrix[:3, :3] = mats[0] @ mats[1] @ mats[2]
        np.fill_diagonal(voxelization_matrix[:3, :3],
                         scale * rng.uniform(*SCALE_AUGMENTATION_BOUND))
        return rotation_matrix @ voxelization_matrix

    def voxelize(self, coords, feats, labels, rng: np.random.RandomState = None, center=None):
        """Returns (voxel_coords int, voxel_feats, voxel_labels,
        inds_reconstruct): the reference voxelize contract
        (voxelizer.py:81-132). With augmentation, draws from `rng`."""
        if coords.shape[1] != 3 or coords.shape[0] != feats.shape[0]:
            raise ValueError("coords must be (N, 3) and match feats")
        if self.use_augmentation and rng is None:
            raise ValueError("an augmenting voxelizer needs the call's RandomState")
        if self.clip_bound is not None:
            trans_aug_ratio = np.zeros(3)
            if self.use_augmentation and self.translation_augmentation_ratio_bound is not None:
                for ax, bound in enumerate(self.translation_augmentation_ratio_bound):
                    trans_aug_ratio[ax] = rng.uniform(*bound)
            keep = self._clip(coords, center, trans_aug_ratio)
            if keep.sum():
                coords, feats = coords[keep], feats[keep]
                labels = labels[keep] if labels is not None else None
        rigid = self._rigid(rng)
        homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
        coords_aug = np.floor(homo @ rigid.T[:, :3])
        coords_aug = np.floor(coords_aug - coords_aug.min(0))

        inds, inds_reconstruct = sparse_quantize(coords_aug)
        # np.unique over the packed key leaves voxels in lexicographic
        # (x, y, z) order, which keeps kernel maps band-local
        coords_out = coords_aug[inds].astype(np.int32)
        labels_out = labels[inds] if labels is not None else None
        return coords_out, feats[inds], labels_out, inds_reconstruct.astype(np.int64)
