"""Whole-scene inference: per-view ensemble + routing, multi-view voting,
the nearest-neighbour fills and the IoU meters.

Counterpart of `xmask3d_tpu/engine/infer.py`. On the device: the
geometric-mean ensemble of fused-feature logits with the MaskCLIP open
logits of the last final 3D mask covering each point, base/novel binary
routing, the 2D branch's fill-and-route, and the vote scatter-add of the
serving view body. On the host (numpy, scipy's cKDTree): the per-view
nearest-covered match, the scene voter with its KD-tree fill of never-seen
points, and the histogram IoU meters.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from xmask3d_tpu_torch.device import category_columns
from xmask3d_tpu_torch.utils.metrics import hiou


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def ensemble_and_route(
    outputs: Dict[str, torch.Tensor],
    base_category: Sequence[int],
    novel_category: Sequence[int],
    num_test_classes: int,
    base_ratio: float = 0.65,
    novel_ratio: float = 0.35,
) -> Dict[str, torch.Tensor]:
    """Per-point class predictions for one view: 'pred' (fused + open
    ensemble) and 'pred_3d', (B, P) int32, plus the normalised text bank."""
    text = _norm(outputs["text_embed_test"].float())
    logit_scale = outputs["logit_scale"]
    fused = _norm(outputs["fused_pred_feature"].float())
    feat2d = _norm(outputs["2d_pred_feature"].float())
    feat3d = _norm(outputs["pure3d_pred_feature"].float())
    logits = torch.softmax(logit_scale * torch.einsum("bpc,lc->bpl", fused, text), dim=-1)
    open_embed = _norm(outputs["final_pred_open_embedding"].float())
    open_logits = torch.softmax(
        logit_scale * torch.einsum("bqc,lc->bql", open_embed, text), dim=-1
    )
    ncls = text.shape[0]
    dev = text.device
    base_cols = category_columns(ncls, base_category, dev)
    novel_cols = category_columns(ncls, novel_category, dev)
    overlap = base_cols.float()

    # later masks overwrite earlier ones on shared points (the reference's
    # sequential loop): each point takes its last covering mask
    mask_3d = outputs["final_mask_3d"] & outputs["final_mask_valid"][:, :, None]
    q_ids = torch.arange(mask_3d.shape[1], device=dev)[None, :, None]
    last_q = torch.where(mask_3d, q_ids, torch.full_like(q_ids, -1)).amax(dim=1)
    covered = last_q >= 0
    idx = last_q.clamp(min=0)[:, :, None].expand(-1, -1, ncls)
    open_per_point = torch.gather(open_logits, 1, idx)  # (B, P, L)

    def geo(a, b, r):
        return torch.log(a.clamp(min=1e-30) ** r * b.clamp(min=1e-30) ** (1 - r))

    ens = geo(logits, open_per_point, base_ratio) * overlap \
        + geo(logits, open_per_point, novel_ratio) * (1 - overlap)
    logits_final = torch.where(covered[..., None], ens, torch.log(logits.clamp(min=1e-30)))

    binary_pred = outputs["binary_pred"].float()[..., None]
    neg = torch.full((), -1e10, dtype=torch.float32, device=dev)

    def route(lg):
        return binary_pred * torch.where(novel_cols, neg, lg) \
            + (1 - binary_pred) * torch.where(base_cols, neg, lg)

    logits_3d = logit_scale * torch.einsum("bpc,lc->bpl", feat3d, text)
    return {
        "pred": route(logits_final).argmax(dim=-1).int(),
        "pred_3d": route(logits_3d).argmax(dim=-1).int(),
        "covered_2d": outputs["covered"],
        "feat_2d": feat2d,
        "binary_pred": binary_pred[..., 0],
        "text": text,
        "logit_scale": logit_scale,
    }


def fill_and_route_2d(
    feat_2d: torch.Tensor,  # (B, P, C) normalised painted 2D features
    match_idx: torch.Tensor,  # (B, P) nearest covered point of each point
    binary_pred: torch.Tensor,  # (B, P) float {0, 1}
    text: torch.Tensor,  # (L, C) normalised text bank
    logit_scale: torch.Tensor,
    base_category: Sequence[int],
    novel_category: Sequence[int],
) -> torch.Tensor:
    """The 2D branch's per-point class (B, P) int32: each point takes the
    features of its match (itself where covered, the nearest covered point
    of the view where not), then the base/novel routing of its logits."""
    idx = match_idx.long()[..., None].expand(-1, -1, feat_2d.shape[-1])
    filled = torch.gather(feat_2d, 1, idx)
    logits = logit_scale * torch.einsum("bpc,lc->bpl", filled.float(), text)
    dev = text.device
    base_cols = category_columns(text.shape[0], base_category, dev)
    novel_cols = category_columns(text.shape[0], novel_category, dev)
    neg = torch.full((), -1e10, dtype=torch.float32, device=dev)
    bp = binary_pred[..., None]
    routed = bp * torch.where(novel_cols, neg, logits) + (1 - bp) * torch.where(base_cols, neg, logits)
    return routed.argmax(dim=-1).int()


def nearest_covered_match(coords: np.ndarray, covered: np.ndarray,
                          valid: np.ndarray) -> np.ndarray:
    """Host side of the per-view fill: for every valid uncovered point, the
    index of the nearest valid covered point (identity elsewhere)."""
    from scipy.spatial import cKDTree

    match = np.arange(len(covered), dtype=np.int32)
    cov = covered & valid
    unc = (~covered) & valid
    if not cov.any() or not unc.any():
        return match
    cov_idx = np.where(cov)[0]
    _, nn = cKDTree(coords[cov_idx]).query(coords[np.where(unc)[0]], k=1)
    match[unc] = cov_idx[nn].astype(np.int32)
    return match


def kdtree_fill(coords: np.ndarray, values: np.ndarray, known: np.ndarray) -> np.ndarray:
    """Fill unknown rows with the nearest known row's value."""
    from scipy.spatial import cKDTree

    if known.all() or not known.any():
        return values
    _, nn = cKDTree(coords[known]).query(coords[~known], k=1)
    out = values.copy()
    out[~known] = values[np.where(known)[0][nn]]
    return out


def view_scene_ids(visible, pv, scene_pv=None):
    """(rows, sids, keep) over min(#visible, P_cap) entries: view row r holds
    the r-th visible scene point; `keep` is the batch's point_valid at those
    rows (never a prefix count: voxel-overflow holes are interior) and, with
    `scene_pv`, the validity of the target scene point."""
    sids = np.where(visible)[0][: pv.shape[0]]
    rows = np.arange(len(sids))
    keep = np.asarray(pv[: len(sids)], bool).copy()
    if scene_pv is not None:
        keep &= sids < len(scene_pv)
        keep &= scene_pv[np.clip(sids, 0, len(scene_pv) - 1)]
    return rows, sids, keep


class SceneVoter:
    """Multi-view per-point class votes of one scene (host)."""

    def __init__(self, num_points: int, num_classes: int):
        self.votes = np.zeros((num_points, num_classes), np.int32)
        self.counter = np.zeros((num_points,), np.int32)

    def add_view(self, point_ids: np.ndarray, preds: np.ndarray):
        self.votes[point_ids, preds] += 1
        self.counter[point_ids] += 1

    def finalize(self, coords: np.ndarray) -> np.ndarray:
        """Each point's most voted class; never-seen points take their
        nearest seen point's."""
        return kdtree_fill(coords, self.votes.argmax(1), self.counter > 0)


def evaluate_scene_predictions(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                               base_category: Sequence[int], novel_category: Sequence[int],
                               ignore: Sequence[int] = (255,)) -> Dict[str, np.ndarray]:
    """Histogram IoU accumulators of one scene (host)."""
    keep = ~np.isin(gt, list(ignore))
    p, g = pred[keep], gt[keep]
    inter, union, target = (np.zeros(num_classes) for _ in range(3))
    for c in range(num_classes):
        pi, gi = p == c, g == c
        inter[c] = (pi & gi).sum()
        union[c] = (pi | gi).sum()
        target[c] = gi.sum()
    return {"inter": inter, "union": union, "target": target}


def summarize_iou(acc: Dict[str, np.ndarray], base_category: Sequence[int],
                  novel_category: Sequence[int]) -> Dict[str, float]:
    iou = acc["inter"] / np.maximum(acc["union"], 1e-10)
    miou_base = float(iou[list(base_category)].mean())
    miou_novel = float(iou[list(novel_category)].mean())
    return {"mIoU_base": miou_base, "mIoU_novel": miou_novel,
            "hIoU": hiou(miou_base, miou_novel), "mIoU": float(iou.mean())}


def device_vote_add(votes: torch.Tensor, counter: torch.Tensor, point_ids: torch.Tensor,
                    preds: torch.Tensor, valid: torch.Tensor):
    """One view's votes: votes (P, C) and counter (P,) int32 stay on the
    device for the whole scene; point_ids / preds / valid are (N,). Rows
    that are invalid or whose id lies outside the table add nothing.
    Updates in place and returns (votes, counter)."""
    n = votes.shape[0]
    keep = valid & (point_ids >= 0) & (point_ids < n)
    ids = torch.where(keep, point_ids, torch.zeros_like(point_ids)).long()
    upd = keep.to(votes.dtype)
    votes.index_put_((ids, preds.long()), upd, accumulate=True)
    counter.index_put_((ids,), upd, accumulate=True)
    return votes, counter
