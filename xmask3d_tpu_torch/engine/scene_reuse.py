"""Scene-level 3D reuse (`--scene_reuse`, `XMASK3D_SCENE_REUSE=1`).

Counterpart of `xmask3d_tpu/engine/scene_reuse.py`. The reference protocol
voxelizes every view and runs both sparse UNets for every view of a scene.
This mode voxelizes the scene once at scene capacities, runs the 3D branch
(`XMask3D.run_3d`) once a scene, keeps its per-point outputs on the device,
and per view gathers the view's rows for the 2D pipeline
(`eval_forward(precomp_3d=...)`). The 3D UNets then see the whole scene
instead of per-view crops, so the numbers differ from the reference
protocol: it is off by default. On CUDA both steps run as captured graphs
(`engine/graphs.py`).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch

from xmask3d_tpu_torch.data.batching import Capacities, _pad1, collate_views
from xmask3d_tpu_torch.data.voxelizer import Voxelizer
from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.engine.graphs import GraphStep, copy_into
from xmask3d_tpu_torch.engine.infer import (
    SceneVoter,
    ensemble_and_route,
    fill_and_route_2d,
    nearest_covered_match,
    view_scene_ids,
)
from xmask3d_tpu_torch.engine.serve import resolve_vote_ids
from xmask3d_tpu_torch.ops.sparse_conv import build_hierarchy, stack_hierarchies


def scene_caps_from_view_caps(caps: Capacities) -> Capacities:
    """Whole-scene capacities: a scene holds four views' worth of points."""
    return Capacities(
        max_points=caps.max_points * 4,
        max_voxels=caps.max_voxels * 4,
        max_targets=caps.max_targets,
        num_levels=caps.num_levels,
        level_divisors=caps.level_divisors,
    )


def scene_3d_batch(locs: np.ndarray, colors, scene_caps: Capacities, voxel_size: float = 0.02,
                   input_color: bool = True, device=None) -> Dict[str, Any]:
    """The whole scene voxelized once (eval pipeline: no augmentation) into
    a `run_3d` batch on `device`. Points beyond capacity, or whose voxel
    fell beyond it, are dropped and marked so in `point_valid`."""
    dev = resolve_device(device)
    n = len(locs)
    if colors is None:
        colors = np.full((n, 3), 127.5, np.float32)
    coords, vfeats, _, inds_rec = Voxelizer(voxel_size=voxel_size).voxelize(
        locs, colors, np.zeros((n,), np.int64))
    v = scene_caps.max_voxels
    coords = coords[:v].astype(np.int32)
    h = build_hierarchy(coords, scene_caps.level_caps())
    p = scene_caps.max_points
    feats = vfeats[:, :3] / 127.5 - 1.0 if input_color else np.ones((len(coords), 3), np.float32)
    pv = np.zeros((p,), bool)
    pv[: min(n, p)] = True
    ir = _pad1(inds_rec.astype(np.int32), p)
    pv &= ir < v
    return {
        "hierarchy": stack_hierarchies([h], dev),
        "voxel_feats": torch.from_numpy(_pad1(feats.astype(np.float32), v)[None]).to(dev),
        "inds_reconstruct": torch.from_numpy(np.where(pv, ir, 0)[None]).to(dev),
        "point_valid": torch.from_numpy(pv[None]).to(dev),
    }


def make_scene_3d_step(model) -> GraphStep:
    """scene batch -> the scene's per-point 3D outputs on the device
    ({imp_condition, pred_3d, binary_scores}), with the batch's
    `point_valid`: consumers must not vote scene points that were dropped,
    since the gathers against the scene tables clamp. A CUDA graph on the
    card; its outputs are overwritten by the next scene."""

    @torch.no_grad()
    def step(scene_batch):
        out = model.run_3d(scene_batch)
        out["point_valid"] = scene_batch["point_valid"]
        return out

    return GraphStep(step, next(model.parameters()).device)


# the leaves of a view's batch that `eval_forward` reads when the 3D
# outputs are given
VIEW_KEYS = ("img", "point_valid", "x_label", "y_label")


def reuse_view_batch(view, caps: Capacities, scene_pv: np.ndarray, device=None):
    """(batch, view_point_ids, rows, sids, keep) of one view for the reuse
    step: the batch holds only `VIEW_KEYS`, collated without the voxel
    hierarchy; `view_point_ids` (1, P_view) int32 are the scene rows the
    view's rows vote for (-1: padding or a dropped scene point), and rows,
    sids, keep are `view_scene_ids`' against the scene batch's validity."""
    dev = resolve_device(device)
    full = collate_views([view["sample"]], caps, device="cpu", hierarchy=False)
    pv = full["point_valid"][0].numpy()
    rows, sids, keep = view_scene_ids(view["visible"], pv, scene_pv)
    ids = np.full((1, pv.shape[0]), -1, np.int32)
    ids[0, rows[keep]] = sids[keep]
    batch = {k: full[k].to(dev) for k in VIEW_KEYS}
    return batch, torch.from_numpy(ids).to(dev), rows, sids, keep


def make_reuse_infer_step(model, cfg):
    """(infer_step, route_2d): infer_step(batch, statics, scene3d,
    view_point_ids) is one view's eval forward on the scene's 3D outputs
    plus the ensemble and routing, a CUDA graph on the card; `batch` holds
    the view's `VIEW_KEYS` and `view_point_ids` (B, P_view) int32 indexes
    the scene's point rows (-1: padding). The gathers run on the device, so
    the scene tables never leave it."""
    mc = model.cfg

    @torch.no_grad()
    def infer_step(batch, statics, scene3d, view_point_ids):
        _, _, precomp = resolve_vote_ids(
            {"point_valid": batch["point_valid"], "vote_point_ids": view_point_ids}, scene3d)
        outputs = model.eval_forward(batch, statics, precomp)
        return ensemble_and_route(outputs, mc.base_category, mc.novel_category,
                                  mc.num_test_classes, cfg.base_ratio, cfg.novel_ratio)

    route_2d = partial(fill_and_route_2d, base_category=mc.base_category,
                       novel_category=mc.novel_category)
    return GraphStep(infer_step, next(model.parameters()).device), route_2d


def run_scene_reuse(scene, scene_3d_step, infer_step, route_2d, statics, caps: Capacities,
                    scene_caps: Capacities, num_classes: int, voxel_size: float = 0.02,
                    input_color: bool = True, device=None, record: Optional[Dict] = None):
    """The scene-reuse counterpart of `infer_cli.run_scene`: one 3D pass a
    scene, one 2D pass a view, the same voting and fill; `record` as there.
    The scene's tables and the statics go into the reuse step's buffers
    once a scene, each view's leaves and ids once a view."""
    dev = resolve_device(device)
    n_pts = len(scene["coords"])
    sb = scene_3d_batch(scene["coords"], scene.get("colors"), scene_caps,
                        voxel_size=voxel_size, input_color=input_color, device=dev)
    # the host's copy of the scene batch's validity: dropped scene points
    # are not voted (the device gathers clamp their ids)
    scene_pv = sb["point_valid"][0].cpu().numpy()
    scene3d = scene_3d_step(sb)
    voters = {k: SceneVoter(n_pts, num_classes) for k in ("pred", "pred_2d", "pred_3d")}
    kept = 0
    for j, view in enumerate(scene["views"]):
        batch, ids, rows, sids, keep = reuse_view_batch(view, caps, scene_pv, device=dev)
        if j == 0:
            infer_step.load(batch, statics, scene3d, ids)
        else:
            copy_into(infer_step.inputs[0], batch)
            copy_into(infer_step.inputs[3], ids)
        preds = infer_step.run()
        pv = batch["point_valid"][0].cpu().numpy()
        coords_p = np.zeros((pv.shape[0], 3), np.float32)
        coords_p[rows] = scene["coords"][sids]
        match = nearest_covered_match(coords_p, preds["covered_2d"][0].cpu().numpy(), pv)
        pred_2d = route_2d(preds["feat_2d"], torch.from_numpy(match)[None].to(dev),
                           preds["binary_pred"].float(), preds["text"], preds["logit_scale"])
        for key, arr in (("pred", preds["pred"]), ("pred_2d", pred_2d),
                         ("pred_3d", preds["pred_3d"])):
            voters[key].add_view(sids[keep], arr[0].cpu().numpy()[rows[keep]])
        kept += int(keep.sum())
    if record is not None:
        record["kept"] = kept
        record["counter"] = {k: int(v.counter.sum()) for k, v in voters.items()}
    return {k: v.finalize(scene["coords"]) for k, v in voters.items()}
