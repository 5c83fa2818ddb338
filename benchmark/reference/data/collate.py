"""One view's raw arrays (`traffic/views.py`) voxelized and padded into the
reference's batch of one view: its own voxelization, its own kernel maps
(numpy), the same capacities and padding rules as the port's
collation."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from benchmark.reference.data.voxelizer import Voxelizer
from benchmark.reference.ops.sparse_conv import build_hierarchy, stack_hierarchies

LEVEL_DIVISORS = (1, 2, 4, 8, 16)


def _pad1(x: np.ndarray, n: int, fill=0):
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    m = min(len(x), n)
    out[:m] = x[:m]
    return out


def pack_targets(label_2d: np.ndarray, max_targets: int):
    """GT target labels from the unique 2D-label values, -1 padded."""
    uniq = np.unique(label_2d)
    labels = np.full((max_targets,), -1, dtype=np.int32)
    labels[: min(len(uniq), max_targets)] = uniq[:max_targets]
    return labels, labels >= 0


def voxelize(view: Dict[str, np.ndarray], voxel_size: float, max_voxels: int):
    """(voxel coords, voxel features in [-1, 1], point -> voxel row)."""
    coords, feats, _, inds = Voxelizer(voxel_size=voxel_size).voxelize(
        view["points"], view["colors"], view["labels_vox"])
    return (coords[:max_voxels], (feats[:max_voxels] / 127.5 - 1.0).astype(np.float32),
            np.clip(inds, 0, max_voxels - 1))


def collate_views(views, max_points: int, max_voxels: int, max_targets: int,
                  voxel_size: float, device) -> Dict[str, Any]:
    """The batch tree of the model's forward for `views` (raw arrays)."""
    caps = tuple(max(16, max_voxels // d) for d in LEVEL_DIVISORS)
    cols: Dict[str, list] = {k: [] for k in (
        "voxel_feats", "point_valid", "inds_reconstruct", "labels_3d", "binary_label_3d",
        "x_label", "y_label", "img", "label_2d", "binary_label_2d", "caption_tokens",
        "target_labels", "target_valid")}
    hs = []
    for v in views:
        coords, feats, inds = voxelize(v, voxel_size, max_voxels)
        coords = np.clip(coords.astype(np.int32), 0, 1023)
        hs.append(build_hierarchy(coords, caps))
        cols["voxel_feats"].append(_pad1(feats, max_voxels))
        pv = np.zeros((max_points,), bool)
        pv[: min(len(inds), max_points)] = True
        ir = _pad1(inds.astype(np.int32), max_points)
        pv &= ir < max_voxels
        cols["point_valid"].append(pv)
        cols["inds_reconstruct"].append(np.where(pv, ir, 0))
        for k, dt in (("labels_3d", np.int32), ("binary_label_3d", np.float32),
                      ("x_label", np.int32), ("y_label", np.int32)):
            cols[k].append(_pad1(v[k].astype(dt), max_points))
        cols["img"].append(v["img"].astype(np.float32))
        cols["label_2d"].append(v["label_2d"].astype(np.int32))
        cols["binary_label_2d"].append(v["binary_label_2d"].astype(np.float32))
        cols["caption_tokens"].append(v["caption_tokens"].astype(np.int32))
        tl, tv = pack_targets(v["label_2d"], max_targets)
        cols["target_labels"].append(tl)
        cols["target_valid"].append(tv)
    batch: Dict[str, Any] = {k: torch.from_numpy(np.stack(a)).to(device) for k, a in cols.items()}
    batch["hierarchy"] = stack_hierarchies(hs, device)
    return batch
