"""Scene-inference serving: one view's forward + routing + vote, and the
whole scene's view loop as one captured device program.

Counterpart of `xmask3d_tpu/engine/serve.py`. The JAX package scans the
view loop inside one device program (`lax.scan`); here the view body is
captured once into a CUDA graph (`engine/graphs.py`) and the scan replays
it for each view from static buffers on the device, with the vote state
on the device for the whole scene and no host sync between views.

Point ids: when each view's rows map to different scene points (real
serving), the batch carries `vote_point_ids` (B, P_view) int32, the scene
point row each view row votes for, -1 for padding (`stack_scene_views`
plumbs it). Rows whose id is negative, outside the vote table or (with
scene reuse) at a scene point the scene batch dropped are not voted.
Without that key each row votes under its own index (one shared point
table, the synthetic bench's shape).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from xmask3d_tpu_torch.data.batching import Capacities, collate_views
from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.engine.graphs import GraphStep, copy_into, flatten, tree_map
from xmask3d_tpu_torch.engine.infer import device_vote_add, ensemble_and_route, view_scene_ids

Votes = Tuple[torch.Tensor, torch.Tensor]


def resolve_vote_ids(batch: Dict[str, Any], scene3d: Optional[Dict[str, torch.Tensor]] = None):
    """(ids, valid, precomp_3d or None) of one view. Without
    `vote_point_ids` rows vote under their own index; with it, -1 marks
    padding. With `scene3d` (scene reuse: the scene's `run_3d` outputs and
    its `point_valid`) the view's rows of the scene tables are gathered into
    `precomp_3d`, and rows whose id is outside the scene table or whose
    scene point was dropped (capacity or voxel overflow) are masked out of
    the vote: the gathers clamp, so those rows carry another row's
    features."""
    pv = batch["point_valid"]
    if "vote_point_ids" in batch:
        ids = batch["vote_point_ids"].to(torch.int32)
    else:
        ids = torch.arange(pv.shape[1], dtype=torch.int32, device=pv.device).expand(pv.shape)
    valid = pv
    if scene3d is None:
        return ids, valid, None
    scene_rows = scene3d["pred_3d"].shape[1]
    gids = ids.clamp(0, scene_rows - 1).long()
    pred_3d = scene3d["pred_3d"]
    precomp = {
        "imp_condition": scene3d["imp_condition"],
        "pred_3d": torch.gather(pred_3d, 1, gids[..., None].expand(-1, -1, pred_3d.shape[-1])),
        "binary_scores": torch.gather(scene3d["binary_scores"], 1, gids),
    }
    valid = valid & (ids >= 0) & (ids < scene_rows)
    if "point_valid" in scene3d:
        valid = valid & torch.gather(scene3d["point_valid"], 1, gids)
    return ids, valid, precomp


def make_view_body(model, cfg, device=None) -> Callable[..., Votes]:
    """view_body(batch, statics, votes, counter, scene3d=None) -> (votes,
    counter), eager.

    `model` and every tensor given to the body live on `device` (the GPU
    unless "cpu" is asked for). The vote state is updated in place.
    `scene3d` is the scene-reuse precompute (`engine/scene_reuse.py`)."""
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"model is not on {dev}")
    mc = model.cfg

    @torch.no_grad()
    def view_body(batch: Dict[str, Any], statics, votes, counter, scene3d=None) -> Votes:
        if batch["img"].device != dev or votes.device != dev:
            raise ValueError(f"batch and vote state must be on {dev}")
        ids, valid, precomp = resolve_vote_ids(batch, scene3d)
        outputs = model.eval_forward(batch, statics, precomp)
        routed = ensemble_and_route(
            outputs, mc.base_category, mc.novel_category, mc.num_test_classes,
            cfg.base_ratio, cfg.novel_ratio,
        )
        return device_vote_add(
            votes, counter, ids.reshape(-1), routed["pred"].reshape(-1), valid.reshape(-1)
        )

    return view_body


def make_scene_scan_step(model, cfg, scene_reuse: bool = False, device=None):
    """scene_scan(stacked, idxseq, statics, votes, counter[, scene3d]) ->
    (votes, counter).

    `stacked`: the per-view batch tree with a leading view axis
    (`stack_scene_views`); `idxseq` (V,) int, on the host, the stacked view
    each step consumes (a bounded buffer of distinct views may be cycled).
    The vote state is copied into the step's buffers once, every view is
    copied from `stacked` into the view body's input buffers on the device
    and the captured body replayed, and the state is copied back once: new
    tensors are returned, the arguments stay as they were. With
    `scene_reuse` a `scene3d` (`make_scene_3d_step`'s output) is required."""
    dev = resolve_device(device)
    step = GraphStep(make_view_body(model, cfg, device=dev), dev)

    def scene_scan(stacked, idxseq, statics, votes, counter, scene3d=None) -> Votes:
        if (scene3d is not None) != scene_reuse:
            raise ValueError(f"scene3d is {'required' if scene_reuse else 'not taken'} "
                             f"with scene_reuse={scene_reuse}")
        order = [int(i) for i in (idxseq.tolist() if torch.is_tensor(idxseq) else idxseq)]
        n_views = stacked["point_valid"].shape[0]
        if any(not 0 <= i < n_views for i in order):
            raise IndexError(f"idxseq {order} indexes {n_views} stacked views")
        if not order:
            return votes.clone(), counter.clone()
        # the view body is one graph whether the scan or a caller captures it:
        # scene3d is an argument only with scene reuse
        step.load(tree_map(lambda t: t[order[0]], stacked), statics, votes, counter,
                  *((scene3d,) if scene_reuse else ()))
        view = step.inputs[0]
        for j, i in enumerate(order):
            if j:
                copy_into(view, tree_map(lambda t: t[i], stacked))
            out = step.run()
        return out[0].clone(), out[1].clone()

    scene_scan.step = step
    return scene_scan


def fresh_vote_state(max_points: int, num_classes: int, device=None) -> Votes:
    dev = resolve_device(device)
    return (
        torch.zeros((max_points, num_classes), dtype=torch.int32, device=dev),
        torch.zeros((max_points,), dtype=torch.int32, device=dev),
    )


def stack_views(batches: Sequence[Dict[str, Any]]):
    """The batch trees of several views, identical in shape, stacked on a
    new leading view axis."""
    sig0, _ = flatten(batches[0])
    leaves = []
    for b in batches:
        sig, ls = flatten(b)
        if sig != sig0:
            raise ValueError("stack_views: views differ in structure or shapes")
        leaves.append(ls)
    stacked = iter([torch.stack(ts) for ts in zip(*leaves)])
    return tree_map(lambda _: next(stacked), batches[0])


def stack_scene_views(scene: Dict[str, Any], caps: Capacities, num_base: int, device=None):
    """A scene dict (`ScanNetSceneViews.scene`, `synthetic_scene`) collated
    into the stacked tree of `make_scene_scan_step`, with each view's scene
    point ids plumbed: view row r holds the r-th visible scene point, so
    `vote_point_ids[v, 0, r]` is the scene row it votes for; capacity
    padding and rows whose voxel overflowed (interior `point_valid` holes:
    the mask, never a prefix count) stay -1.

    Returns (stacked on `device`, idxseq (V,) int32 on the host, the scene's
    point count); size the vote table with fresh_vote_state(points, ...):
    scene ids are not clamped to the view capacity. `num_base` is the JAX
    signature's; the port's collation does not read it."""
    dev = resolve_device(device)
    batches = []
    for view in scene["views"]:
        b = collate_views([view["sample"]], caps, device="cpu")
        pv = b["point_valid"][0].numpy()
        rows, sids, keep = view_scene_ids(view["visible"], pv)
        ids = np.full((1, pv.shape[0]), -1, np.int32)
        ids[0, rows[keep]] = sids[keep]
        b["vote_point_ids"] = torch.from_numpy(ids)
        batches.append(b)
    stacked = tree_map(lambda t: t.to(dev), stack_views(batches))
    return stacked, torch.arange(len(batches), dtype=torch.int32), len(scene["coords"])
