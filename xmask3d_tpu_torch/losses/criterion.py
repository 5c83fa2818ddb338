"""XMask3D's loss terms as batched functions.

Counterpart of `xmask3d_tpu/losses/criterion.py`: the Mask2Former class and
point-sampled mask losses, loss_exact (per-point CE through the CLIP text
bank), loss_contra (novel/base-dominant masks aligned to detached MaskCLIP
embeddings), the caption cosine losses and the base/novel binary BCE. The
mask loss takes its random coordinates as inputs (`ops/point_sample.py`).

Every loss is a sum over the batch divided by a count. Under a process
group the count is the global batch's (`parallel/mesh.py` `global_sum`,
detached, over the data axis) and each rank returns its own sum over it,
so a data group's losses add up to the one-process loss of the global
batch, as under the JAX package's data mesh. The ranks of one model group
hold the same rows and return the same losses.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from xmask3d_tpu_torch.ops.point_sample import (
    dice_loss,
    point_sample,
    sigmoid_ce_loss,
    uncertainty_sampled_points,
)
from xmask3d_tpu_torch.parallel.mesh import global_sum


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _log_softmax_pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def loss_labels(pred_logits: torch.Tensor, target_labels: torch.Tensor,
                target_valid: torch.Tensor, match: torch.Tensor,
                eos_coef: float = 0.1) -> torch.Tensor:
    """Weighted CE over all queries (B, Q, C + 1); unmatched queries take the
    no-object class at weight eos_coef."""
    b, q, c1 = pred_logits.shape
    num_classes = c1 - 1
    tgt = torch.full((b, q), num_classes, dtype=torch.long, device=pred_logits.device)
    vals = torch.where(target_valid, target_labels.long(), torch.full_like(tgt[:, :1], num_classes))
    tgt = tgt.scatter(1, match.long(), vals)
    ce = _log_softmax_pick(pred_logits, tgt)
    w = torch.where(tgt == num_classes, eos_coef, 1.0)
    return (ce * w).sum() / global_sum(w.sum()).clamp(min=1e-8)


def loss_masks(pred_masks: torch.Tensor, target_masks: torch.Tensor,
               target_valid: torch.Tensor, match: torch.Tensor, num_masks: torch.Tensor,
               over: torch.Tensor, refill: torch.Tensor, num_points: int = 12544,
               importance_sample_ratio: float = 0.75):
    """Point-sampled sigmoid-CE and dice losses of the matched (pred, target)
    pairs, on coordinates importance-sampled from `over` and `refill`
    ((B * T, ..., 2) each), over `num_masks` (the global count of valid
    targets)."""
    b, t = match.shape
    h, w = pred_masks.shape[2:]
    matched = torch.gather(pred_masks, 1, match.long()[:, :, None, None].expand(b, t, h, w))
    mp = matched.reshape(b * t, 1, h, w)
    mt = target_masks.reshape(b * t, 1, *target_masks.shape[2:])
    with torch.no_grad():
        coords = uncertainty_sampled_points(mp, over, refill, num_points,
                                            importance_sample_ratio)
        labels = point_sample(mt, coords)[:, 0]
    logits = point_sample(mp, coords)[:, 0]  # (B * T, N)
    valid = target_valid.reshape(-1).float()
    l_ce = (sigmoid_ce_loss(logits, labels) * valid).sum() / num_masks
    l_dice = (dice_loss(logits, labels) * valid).sum() / num_masks
    return l_ce, l_dice


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                         ignore_label: int) -> torch.Tensor:
    keep = (valid & (labels != ignore_label)).float()
    ce = _log_softmax_pick(logits, labels.clamp(0, logits.shape[-1] - 1))
    return (ce * keep).sum() / global_sum(keep.sum()).clamp(min=1.0)


def bank_logits(x: torch.Tensor, text_embed: torch.Tensor, null_embed: torch.Tensor,
                logit_scale) -> torch.Tensor:
    """Per-point logits (B, P, L + 1) through the normalised text bank."""
    bank = _normalize(torch.cat([text_embed, null_embed], dim=0))
    return logit_scale * torch.einsum("bpc,lc->bpl", _normalize(x).float(), bank.float())


def loss_exact(fused, pure_3d, text_embed, null_embed, logit_scale, labels_3d,
               point_valid, ignore_label: int) -> Dict[str, torch.Tensor]:
    """Per-point CE of the fused and the pure-3D features through the bank."""
    return {
        "loss_3d": masked_cross_entropy(bank_logits(fused, text_embed, null_embed, logit_scale),
                                        labels_3d, point_valid, ignore_label),
        "loss_3d_pure": masked_cross_entropy(
            bank_logits(pure_3d, text_embed, null_embed, logit_scale),
            labels_3d, point_valid, ignore_label),
    }


def cosine_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return 1.0 - (_normalize(a, eps) * _normalize(b, eps)).sum(-1)


def loss_contra(mask_3d: torch.Tensor, mask_logits: torch.Tensor,
                clip_mask_embed: torch.Tensor, feature_3d: torch.Tensor,
                binary_gt: torch.Tensor, point_valid: torch.Tensor, num_novel: int = 4,
                num_base: int = 1) -> torch.Tensor:
    """Cosine alignment of masks' mean 3D features to their detached
    MaskCLIP embeddings, over the top-4 novel-dominant and top-1
    base-dominant masks by mean over-threshold confidence (the JAX
    package's selection rules, exactly)."""
    with torch.no_grad():
        m = mask_3d & point_valid[:, None, :]
        none_kept = ~(m.sum(-1) >= 10).any(-1)
        m = m.clone()
        m[:, 0] = torch.where(none_kept[:, None], point_valid, m[:, 0])
        npts = m.sum(-1)
        keep10 = npts >= 10
        novel_num = ((binary_gt == 0)[:, None, :] & m).sum(-1)
        base_num = npts - novel_num
        base_num_ = ((binary_gt == 1)[:, None, :] & m).sum(-1)
        novel_num_ = npts - base_num_
        novel_flag = keep10 & (novel_num > 1.8 * base_num) & (novel_num > 10)
        base_flag = keep10 & ~novel_flag & (base_num_ > 20 * novel_num_) & (base_num_ > 150)
        sig = torch.sigmoid(mask_logits.float())
        over = (sig > 0.5).float()
        score = (sig * over).sum((-1, -2)) / over.sum((-1, -2)).clamp(min=1e-8)
        neg = torch.full((), -1e30, device=score.device)
        novel_idx = torch.topk(torch.where(novel_flag, score, neg), num_novel, dim=1).indices
        base_idx = torch.topk(torch.where(base_flag, score, neg), num_base, dim=1).indices
        sel_idx = torch.cat([novel_idx, base_idx], dim=-1)  # (B, S)
        sel_valid = torch.cat([torch.gather(novel_flag, 1, novel_idx),
                               torch.gather(base_flag, 1, base_idx)], dim=-1)
        w = torch.gather(m, 1, sel_idx[..., None].expand(-1, -1, m.shape[2])).float()
        gt = torch.gather(clip_mask_embed, 1,
                          sel_idx[..., None].expand(-1, -1, clip_mask_embed.shape[2])).float()
    emb_3d = torch.einsum("bsp,bpc->bsc", w, feature_3d.float())
    emb_3d = emb_3d / w.sum(-1, keepdim=True).clamp(min=1e-8)
    sv = sel_valid.float()
    total = (cosine_loss(emb_3d, gt) * sv).sum()
    count = global_sum(sv.sum())
    return torch.where(count > 0, total / count.clamp(min=1.0), torch.zeros((), device=total.device))


def binary_bce_loss(scores: torch.Tensor, labels: torch.Tensor, point_valid: torch.Tensor,
                    ignore_ids: Sequence[int], pos_weight: float) -> torch.Tensor:
    """BCE with logits and pos_weight over valid points, ignoring the
    configured categories."""
    keep = point_valid
    for ig in ignore_ids:
        keep = keep & (labels != ig)
    y = labels.float()
    x = scores.float()
    bce = pos_weight * y * F.softplus(-x) + (1 - y) * F.softplus(x)
    k = keep.float()
    return (bce * k).sum() / global_sum(k.sum()).clamp(min=1.0)


def caption_cosine_loss(features: torch.Tensor, weight: torch.Tensor,
                        caption_embed: torch.Tensor) -> torch.Tensor:
    """1 - cos(weighted mean feature, caption embedding), averaged over scenes."""
    w = weight.float()[..., None]
    mean = (features.float() * w).sum(1) / w.sum(1).clamp(min=1e-8)
    scenes = global_sum(torch.full((), float(features.shape[0]), device=features.device))
    return cosine_loss(mean, caption_embed.float()).sum() / scenes
