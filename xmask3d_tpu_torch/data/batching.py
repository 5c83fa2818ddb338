"""Static-shape batch assembly: own copy of `xmask3d_tpu/data/batching.py`.

Each per-view sample is padded to configured capacities; the batch is a dict
of tensors on the chosen device with validity masks, and `hierarchy` is a
`SparseHierarchy` of tensors (or, for a hierarchy built on the device,
`voxel_coords` and `voxel_num`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.ops.sparse_conv import build_hierarchy, stack_hierarchies
from xmask3d_tpu_torch.utils.spans import span


@dataclass
class Capacities:
    """Static capacities for one view-sample."""

    max_points: int = 65536
    max_voxels: int = 49152
    max_targets: int = 24
    num_levels: int = 5
    level_divisors: Sequence[int] = (1, 2, 4, 8, 16)

    def level_caps(self):
        return tuple(max(16, self.max_voxels // d) for d in self.level_divisors)


def _pad1(x: np.ndarray, n: int, fill=0):
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    m = min(len(x), n)
    out[:m] = x[:m]
    return out


@dataclass
class ViewSample:
    """One (scene-view) sample before padding. All numpy."""

    voxel_coords: np.ndarray  # (V, 3) int32
    voxel_feats: np.ndarray  # (V, 3) float32 in [-1, 1]
    inds_reconstruct: np.ndarray  # (P,) point -> voxel row
    labels_3d: np.ndarray  # (P,)
    binary_label_3d: np.ndarray  # (P,) float32
    x_label: np.ndarray  # (P,) row in mask space
    y_label: np.ndarray  # (P,) col in mask space
    img: np.ndarray  # (H, W, 3) float32, 0..255 (NHWC)
    label_2d: np.ndarray  # (H, W)
    binary_label_2d: np.ndarray  # (128, 128) float32
    caption_tokens: np.ndarray  # (T,) int32


def pack_targets(label_2d: np.ndarray, max_targets: int):
    """GT target labels from the unique 2D-label values, -1 padded."""
    uniq = np.unique(label_2d)
    labels = np.full((max_targets,), -1, dtype=np.int32)
    labels[: min(len(uniq), max_targets)] = uniq[:max_targets]
    return labels, labels >= 0


def collate_views(samples: List[ViewSample], caps: Capacities, device=None,
                  grid_jitter_rng=None, hierarchy: bool = True, device_hierarchy: bool = False,
                  builder: str = "native") -> Dict[str, Any]:
    """Pad and stack view samples into a fixed-shape batch of tensors on
    `device` (the GPU unless "cpu" is asked for). `grid_jitter_rng` (a numpy
    RandomState; training only) shifts the whole batch's voxel coords by
    one integer translation in [0, 16) a batch, which re-draws which voxels
    pool together at every stride, as the JAX package does. Stride-1 coords
    are clipped to [0, 1023] per axis, the device builder's key range.

    The voxel hierarchy is built on the host by `builder` ("native" or
    "numpy", `ops/sparse_conv.py` `build_hierarchy`) into `hierarchy`. With
    `device_hierarchy` the batch ships only `voxel_coords` (B, V, 3) int32,
    zero-padded, and `voxel_num` (B,) int32, and the model builds the
    hierarchy on the device (`ops/hierarchy_device.py`). Without
    `hierarchy` neither is in the batch: scene reuse runs no per-view 3D
    pass. Each hierarchy build is the span `xm3d.view.hierarchy`
    (`utils/spans.py`)."""
    device = resolve_device(device)
    jitter = None if grid_jitter_rng is None \
        else grid_jitter_rng.randint(0, 16, size=(1, 3)).astype(np.int32)
    p, v = caps.max_points, caps.max_voxels
    hs, vox_coords, vox_num = [], [], []
    vox_feats, point_valid, tgt_labels, tgt_valid = [], [], [], []
    fields: Dict[str, List[np.ndarray]] = {
        k: [] for k in ("inds_reconstruct", "labels_3d", "binary_label_3d", "x_label", "y_label")
    }
    for s in samples:
        coords = s.voxel_coords[:v].astype(np.int32)
        if jitter is not None:
            coords = coords + jitter
        coords = np.clip(coords, 0, 1023)
        if hierarchy and device_hierarchy:
            vox_coords.append(_pad1(coords, v))
            vox_num.append(np.int32(len(coords)))
        elif hierarchy:
            with span("xm3d.view.hierarchy"):
                hs.append(build_hierarchy(coords, caps.level_caps(), builder=builder))
        vox_feats.append(_pad1(s.voxel_feats.astype(np.float32), v))
        pv = np.zeros((p,), bool)
        pv[: min(len(s.inds_reconstruct), p)] = True
        ir = _pad1(s.inds_reconstruct.astype(np.int32), p)
        pv &= ir < v  # points whose voxel fell beyond capacity
        point_valid.append(pv)
        fields["inds_reconstruct"].append(np.where(pv, ir, 0))
        fields["labels_3d"].append(_pad1(s.labels_3d.astype(np.int32), p))
        fields["binary_label_3d"].append(_pad1(s.binary_label_3d.astype(np.float32), p))
        fields["x_label"].append(_pad1(s.x_label.astype(np.int32), p))
        fields["y_label"].append(_pad1(s.y_label.astype(np.int32), p))
        tl, tv = pack_targets(s.label_2d, caps.max_targets)
        tgt_labels.append(tl)
        tgt_valid.append(tv)

    def t(arrs):
        return torch.from_numpy(np.stack(arrs)).to(device)

    batch: Dict[str, Any] = {}
    if hierarchy and device_hierarchy:
        batch["voxel_coords"] = t(vox_coords)
        batch["voxel_num"] = t(vox_num)
    elif hierarchy:
        batch["hierarchy"] = stack_hierarchies(hs, device)
    batch["voxel_feats"] = t(vox_feats)
    batch["point_valid"] = t(point_valid)
    for k, vals in fields.items():
        batch[k] = t(vals)
    batch["img"] = t([s.img.astype(np.float32) for s in samples])
    batch["label_2d"] = t([s.label_2d.astype(np.int32) for s in samples])
    batch["binary_label_2d"] = t([s.binary_label_2d.astype(np.float32) for s in samples])
    batch["caption_tokens"] = t([s.caption_tokens.astype(np.int32) for s in samples])
    batch["target_labels"] = t(tgt_labels)
    batch["target_valid"] = t(tgt_valid)
    return batch
