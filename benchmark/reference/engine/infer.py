"""Per-view ensemble and routing: the geometric-mean ensemble of
fused-feature logits with the MaskCLIP open logits of the last final 3D
mask covering each point, and the base/novel binary routing."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from benchmark.reference.device import category_columns


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
    routed = route(logits_final)
    return {
        "routed": routed,
        "pred": routed.argmax(dim=-1).int(),
        "pred_3d": route(logits_3d).argmax(dim=-1).int(),
        "covered_2d": outputs["covered"],
        "feat_2d": feat2d,
        "binary_pred": binary_pred[..., 0],
        "text": text,
        "logit_scale": logit_scale,
    }
