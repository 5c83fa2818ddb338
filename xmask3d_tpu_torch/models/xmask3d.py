"""XMask3D top-level model: one view's eval forward and the training losses.

Counterpart of `xmask3d_tpu/models/xmask3d.py`: the two sparse 3D UNets
(with their k5 stems fused into one conv, except under `XMASK3D_BRICK=1`,
`ops/brick_conv.py`), the SD feature backbone
conditioned on the 3D global embedding, the MSDeformAttn pixel decoder, the
ODISE mask decoder, MaskCLIP, binary base/novel routing, the panoptic filter
and the 2D -> 3D paint-and-fuse; `train_forward` adds the matcher and the
loss stack. Submodule names follow the JAX parameter tree, so
`checkpoint/from_jax.py` maps weights mechanically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xmask3d_tpu_torch.device import category_columns
from xmask3d_tpu_torch.losses import criterion as L
from xmask3d_tpu_torch.losses.fuser import (
    FeatureMerger,
    paint_and_fuse,
    panoptic_mask_filter,
    project_masks_to_points,
)
from xmask3d_tpu_torch.losses.matcher import match_costs
from xmask3d_tpu_torch.models.backbone import FeatureExtractorBackbone
from xmask3d_tpu_torch.models.clip import build_clip
from xmask3d_tpu_torch.models.layers import resize, set_remat
from xmask3d_tpu_torch.models.ldm_extractor import LDM_SD_V1, LdmConfig
from xmask3d_tpu_torch.models.mask_decoder import CategoryEmbed, ODISEMaskedTransformerDecoder
from xmask3d_tpu_torch.models.minkunet import MaskedBatchNorm, bricks_enabled, mink_unet
from xmask3d_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from xmask3d_tpu_torch.ops.hierarchy_device import build_hierarchy_on_device
from xmask3d_tpu_torch.ops.hungarian import linear_sum_assignment
from xmask3d_tpu_torch.ops.sparse_conv import sparse_conv
from xmask3d_tpu_torch.parallel.mesh import global_sum
from xmask3d_tpu_torch.utils.metrics import intersection_and_union
from xmask3d_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class XMask3DConfig:
    num_classes: int = 15
    num_test_classes: int = 19
    num_queries: int = 50
    arch_3d: str = "MinkUNet34C"
    arch_binary_head: str = "MinkUNet18A"
    mask_shape: Tuple[int, int] = (240, 320)
    clip_name: str = "ViT-L-14"
    ldm: LdmConfig = LDM_SD_V1
    projection_dim: int = 768
    base_category: Sequence[int] = (0, 1, 2, 3, 4, 6, 7, 8, 10, 11, 13, 14, 15, 17, 18)
    novel_category: Sequence[int] = (5, 9, 12, 16)
    ignore_category: Sequence[int] = (19, 20)
    ignore_label: int = 15
    data_ratio: float = 0.267
    binary_2d_thresh: float = 0.5
    scores_keep_thresh: float = 0.0
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    eos_coef: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    caption_contra: bool = True
    caption_contra_2d_pre: bool = True
    caption_contra_3d: bool = True
    mask_contra_3d: bool = True
    dec_layers: int = 9
    pixel_enc_layers: int = 6
    dtype: torch.dtype = torch.float32
    # the VAE resblocks' GroupNorm -> SiLU -> conv3x3 stages on kernel K4
    fused_gn: bool = False
    # block-level remat of the SD VAE and UNet where autograd records them
    # (training); eval does not change
    remat_backbone: bool = False


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def cal_pred_logits(mask_embed, text_embed, null_embed, logit_scale) -> torch.Tensor:
    """CLIP-space class logits + null column: (B, Q, L + 1) fp32."""
    me = _normalize(mask_embed).float()
    pred = logit_scale * torch.einsum("bqc,lc->bql", me, _normalize(text_embed).float())
    null = logit_scale * torch.einsum("bqc,lc->bql", me, _normalize(null_embed).float())
    return torch.cat([pred, null], dim=-1)


class PCProcessor(nn.Module):
    """MinkUNet + text-space adapters."""

    def __init__(self, arch: str = "MinkUNet34C", proj_dim: int = 768, last_dim: int = 256):
        super().__init__()
        self.MinkUNet_0 = mink_unet(out_channels=last_dim, arch=arch)
        self.point2text_adapter = nn.Linear(self.MinkUNet_0.planes[3], proj_dim)
        self.decoder = nn.Linear(last_dim, proj_dim)

    def forward(self, feats, hierarchy, stem_conv=None):
        bottleneck, out = self.MinkUNet_0(feats, hierarchy, stem_conv=stem_conv)
        return self.point2text_adapter(bottleneck), self.decoder(out)


class PCBinaryProcessor(nn.Module):
    """MinkUNet -> BN -> ReLU -> Linear(1) base/novel head."""

    def __init__(self, arch: str = "MinkUNet18A", last_dim: int = 256):
        super().__init__()
        self.MinkUNet_0 = mink_unet(out_channels=last_dim, arch=arch)
        self.bn = MaskedBatchNorm(last_dim)
        self.fc = nn.Linear(last_dim, 1)

    def forward(self, feats, hierarchy, stem_conv=None):
        _, out = self.MinkUNet_0(feats, hierarchy, stem_conv=stem_conv)
        return self.fc(F.relu(self.bn(out, hierarchy.levels[0].valid)))


class XMask3D(nn.Module):
    """The full pipeline. `statics` carries the frozen text banks and the
    uncond tokens (see `engine/builder.py` `build_statics`)."""

    def __init__(self, cfg: XMask3DConfig = XMask3DConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.pc_decoder = PCProcessor(arch=c.arch_3d)
        self.pc_binary_head = PCBinaryProcessor(arch=c.arch_binary_head)
        self.backbone = FeatureExtractorBackbone(c.ldm, fused_gn=c.fused_gn)
        set_remat(self.backbone, c.remat_backbone)
        self.pixel_decoder = MSDeformAttnPixelDecoder(enc_layers=c.pixel_enc_layers)
        self.mask_decoder = ODISEMaskedTransformerDecoder(
            num_classes=c.num_classes, num_queries=c.num_queries,
            dec_layers=c.dec_layers, projection_dim=c.projection_dim,
        )
        self.category_embed = CategoryEmbed(embed_dim=c.projection_dim)
        self.clip = build_clip(c.clip_name)
        self.fuser = FeatureMerger(feature_dim=c.projection_dim)

    # -- 3D branch ---------------------------------------------------------
    def run_3d(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Sparse UNets -> per-point features, global embedding, binary
        scores. Both UNets' k5 stems run as ONE sparse conv with their
        kernels concatenated on the output axis (same contraction per
        output column). A batch without a `hierarchy` ships `voxel_coords`
        and `voxel_num`, and the hierarchy is built here on the device
        (`ops/hierarchy_device.py`), at capacities from the coords' rows."""
        h = batch.get("hierarchy")
        if h is None:
            v0 = batch["voxel_coords"].shape[1]
            caps = tuple(max(16, v0 // d) for d in (1, 2, 4, 8, 16))
            h = build_hierarchy_on_device(batch["voxel_coords"], batch["voxel_num"], caps)
        dt = self.cfg.dtype
        feats = batch["voxel_feats"].to(dt)
        if bricks_enabled():
            # the brick-dense layout has its own stem in each UNet, as in
            # the JAX package, whose fused stem is off under XMASK3D_BRICK
            stem34 = stem14 = None
        else:
            w34 = self.pc_decoder.MinkUNet_0.conv0.kernel
            w14 = self.pc_binary_head.MinkUNet_0.conv0.kernel
            stem = sparse_conv(feats, torch.cat([w34, w14], dim=-1).to(dt), h.kmap5,
                               out_valid=h.levels[0].valid)
            stem34, stem14 = stem.split([w34.shape[-1], w14.shape[-1]], dim=-1)
        implicit, pred_3d_vox = self.pc_decoder(feats, h, stem_conv=stem34)
        neg = torch.finfo(implicit.dtype).min
        bneck_valid = h.levels[-1].valid
        imp_condition = torch.where(
            bneck_valid[..., None], implicit, torch.full((), neg, dtype=implicit.dtype, device=implicit.device)
        ).amax(dim=1)
        ir = batch["inds_reconstruct"].long()
        pred_3d = torch.gather(pred_3d_vox, 1, ir[..., None].expand(-1, -1, pred_3d_vox.shape[-1]))
        binary_vox = self.pc_binary_head(feats, h, stem_conv=stem14)
        binary_scores = torch.gather(binary_vox[..., 0], 1, ir)
        return {"imp_condition": imp_condition, "pred_3d": pred_3d, "binary_scores": binary_scores}

    def _trunk(self, batch, statics, precomp_3d=None):
        """3D branch (or the scene's precomputed `run_3d` outputs), SD
        backbone, pixel and mask decoders."""
        three_d = precomp_3d if precomp_3d is not None else self.run_3d(batch)
        img01 = batch["img"] / 255.0
        feats = self.backbone(img01, three_d["imp_condition"], statics["uncond_tokens"])
        mask_features, ms_feats = self.pixel_decoder(feats)
        outputs = self.mask_decoder(ms_feats, mask_features)
        outputs["pred_3d"] = three_d["pred_3d"]
        outputs["binary_scores"] = three_d["binary_scores"]
        outputs["images"] = img01
        return outputs

    def _clip_mask_embed(self, img01, pred_masks):
        """MaskCLIP embeddings of the predicted masks; bilinear resizes
        without antialiasing."""
        s = self.clip.vision_cfg.image_size
        img = resize(img01, (s, s), (1, 2), "bilinear", antialias=False)
        masks = resize(pred_masks, (s, s), (2, 3), "bilinear", antialias=False)
        return self.clip.encode_image_with_mask(img, masks)

    def embed_captions(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.clip.embed_text(tokens)[0]

    def forward(self, batch, statics, train: bool = False, draws=None):
        """(losses, outputs) of `train_forward` with `train`, else (None,
        eval outputs)."""
        if train:
            return self.train_forward(batch, statics, draws)
        return None, self.eval_forward(batch, statics)

    # -- train forward -----------------------------------------------------
    def train_forward(self, batch: Dict[str, Any], statics: Dict[str, torch.Tensor],
                      draws: Dict[str, torch.Tensor]):
        """The training losses of one batch, line by line after the JAX
        package's `train_forward`. `draws` holds the step's uniform point
        coordinates (`ops/point_sample.py` `point_draws`). Returns (losses,
        outputs); `metric_*` entries are IoU histograms, not losses."""
        c = self.cfg
        with span("xm3d.forward.trunk"):
            outputs = self._trunk(batch, statics)
        caption_embed = self.embed_captions(batch["caption_tokens"])
        cat = self.category_embed(statics["text_embed_train"])
        text_embed, null_embed = cat["text_embed"], cat["null_embed"]
        logit_scale = outputs["logit_scale"]
        layers = [outputs] + list(outputs["aux_outputs"])
        for layer in layers:
            layer["pred_logits"] = cal_pred_logits(layer["mask_embed"], text_embed, null_embed,
                                                   layer["logit_scale"])

        # targets from label_2d
        tl, tv = batch["target_labels"], batch["target_valid"]
        target_masks = (batch["label_2d"][:, None] == tl[:, :, None, None]).float() \
            * tv[:, :, None, None]
        num_masks = global_sum(tv.sum().float()).clamp(min=1.0)  # over the global batch

        # matcher of every layer: one host copy of all cost matrices
        costs = torch.stack([
            match_costs(layer["pred_logits"], layer["pred_masks"], tl, target_masks, tv,
                        draws["matcher"][i], c.class_weight, c.mask_weight, c.dice_weight)
            for i, layer in enumerate(layers)])
        matches = linear_sum_assignment(costs)  # (layers, B, T)
        losses: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(layers):
            suffix = "" if i == 0 else f"_{i - 1}"
            losses[f"loss_ce{suffix}"] = L.loss_labels(layer["pred_logits"], tl, tv, matches[i],
                                                       c.eos_coef)
            losses[f"loss_mask{suffix}"], losses[f"loss_dice{suffix}"] = L.loss_masks(
                layer["pred_masks"], target_masks, tv, matches[i], num_masks,
                draws["over"][i], draws["refill"][i], c.num_points, c.importance_sample_ratio)

        # MaskCLIP embeddings: only loss_contra reads them, and detached
        with torch.no_grad():
            clip_mask_embed = self._clip_mask_embed(outputs["images"], outputs["pred_masks"])
        outputs["mask_embed_clip"] = clip_mask_embed
        masks_mshape = resize(outputs["pred_masks"], c.mask_shape, (2, 3), "bilinear",
                              antialias=False)

        # panoptic filter (every query enters the claim: keep = score > 0),
        # projection to points, paint and fuse
        pv, xl, yl = batch["point_valid"], batch["x_label"], batch["y_label"]
        with torch.no_grad():
            scores = torch.softmax(outputs["pred_logits"].float(), dim=-1).amax(dim=-1)
            final_masks, final_valid = panoptic_mask_filter(scores, masks_mshape, scores > 0)
            mask_3d = project_masks_to_points(final_masks, xl, yl)
        fused_out = paint_and_fuse(mask_3d, final_valid, outputs["mask_embed"],
                                   outputs["pred_3d"], pv, self.fuser)
        fused = fused_out["fused"]
        outputs.update({"fused_pred_feature": fused, "2d_pred_feature": fused_out["feat_2d"],
                        "pure3d_pred_feature": outputs["pred_3d"]})

        losses.update(L.loss_exact(fused, outputs["pred_3d"], text_embed, null_embed,
                                   logit_scale, batch["labels_3d"], pv, c.ignore_label))
        # training-time IoU histograms of the fused prediction
        with torch.no_grad():
            train_pred = L.bank_logits(fused, text_embed, null_embed, 1.0).argmax(dim=-1)
            inter, union, _ = intersection_and_union(
                train_pred, batch["labels_3d"], c.num_classes, ignore_index=(c.ignore_label,),
                valid=pv)
        losses["metric_train_inter"] = inter
        losses["metric_train_union"] = union

        if c.mask_contra_3d:
            with torch.no_grad():
                raw_mask3d = torch.sigmoid(project_masks_to_points(masks_mshape, xl, yl)) >= 0.5
            losses["loss_3d_contra"] = L.loss_contra(
                raw_mask3d, masks_mshape, clip_mask_embed, outputs["pred_3d"],
                batch["binary_label_3d"], pv)
        if c.caption_contra:
            losses["loss_explicit_contra"] = L.caption_cosine_loss(fused, pv, caption_embed)
        if c.caption_contra_3d:
            losses["loss_explicit_contra_3d"] = L.caption_cosine_loss(
                outputs["pred_3d"], pv, caption_embed)
        if c.caption_contra_2d_pre:
            losses["loss_explicit_contra_2d_pre"] = L.caption_cosine_loss(
                fused_out["feat_2d"], pv & fused_out["covered"], caption_embed)
        losses["loss_binary"] = L.binary_bce_loss(
            outputs["binary_scores"], batch["binary_label_3d"], pv, c.ignore_category,
            c.data_ratio)
        return losses, outputs

    # -- eval forward ------------------------------------------------------
    @torch.no_grad()
    def eval_forward(self, batch: Dict[str, Any], statics: Dict[str, torch.Tensor],
                     precomp_3d: Optional[Dict[str, torch.Tensor]] = None):
        """One view's eval outputs. `precomp_3d` ({imp_condition, pred_3d,
        binary_scores} at the view's point rows, as scene reuse gathers them
        from one pass over the scene) takes the place of `run_3d`."""
        c = self.cfg
        outputs = self._trunk(batch, statics, precomp_3d)
        cat = self.category_embed(statics["text_embed_test"])
        text_embed, null_embed = cat["text_embed"], cat["null_embed"]
        pred_logits = cal_pred_logits(outputs["mask_embed"], text_embed, null_embed,
                                      outputs["logit_scale"])
        outputs["pred_logits"] = pred_logits
        clip_mask_embed = self._clip_mask_embed(outputs["images"], outputs["pred_masks"])
        outputs["mask_embed_clip"] = clip_mask_embed

        masks_mshape = resize(outputs["pred_masks"], c.mask_shape, (2, 3), "bilinear",
                              antialias=False)
        pv = batch["point_valid"]
        xl, yl = batch["x_label"], batch["y_label"]
        mask_3d_full = (torch.sigmoid(project_masks_to_points(masks_mshape, xl, yl)) > 0.5) \
            & pv[:, None, :]
        keep_full = mask_3d_full.sum(-1) > 0
        binary_sig = torch.sigmoid(outputs["binary_scores"].float())
        mf = mask_3d_full.float()
        binary_vote = torch.einsum("bqp,bp->bq", mf, binary_sig) / (mf.sum(-1) + 1e-10)
        is_base = binary_vote > c.binary_2d_thresh

        num_cls = c.num_test_classes
        n_col, dev = pred_logits.shape[-1], pred_logits.device
        base_cols = category_columns(n_col, c.base_category, dev)
        novel_cols = category_columns(n_col, c.novel_category, dev)
        null_col = category_columns(n_col, (num_cls,), dev)
        neg = torch.full((), -1e10, dtype=pred_logits.dtype, device=dev)
        logits_novel = torch.where(base_cols | null_col, neg, pred_logits)
        logits_base = torch.where(novel_cols, neg, pred_logits)
        modified = torch.where(is_base[..., None], logits_base, logits_novel)
        probs = torch.softmax(modified.float(), dim=-1)
        scores = probs.amax(dim=-1)
        labels = probs.argmax(dim=-1)  # first index on ties, as jnp.argmax
        labels = torch.where(labels > num_cls - 1, torch.full_like(labels, num_cls), labels)

        keep = (scores > c.scores_keep_thresh) & keep_full
        final_masks, final_valid = panoptic_mask_filter(scores, masks_mshape, keep)
        mask_3d = project_masks_to_points(final_masks, xl, yl) & pv[:, None, :]
        fused_out = paint_and_fuse(mask_3d, final_valid, outputs["mask_embed"],
                                   outputs["pred_3d"], pv, self.fuser)
        outputs.update({
            "fused_pred_feature": fused_out["fused"],
            "2d_pred_feature": fused_out["feat_2d"],
            "pure3d_pred_feature": outputs["pred_3d"],
            "covered": fused_out["covered"],
            "final_mask_3d": mask_3d,
            "final_mask_valid": final_valid,
            "final_pred_open_embedding": clip_mask_embed,
            "binary_pred": (binary_sig > 0.5).int(),
            "binary_sig": binary_sig,
            "mask_cls_results": pred_logits,
            "pred_labels": labels.int(),
            "pred_scores": scores,
            "text_embed_test": text_embed,
            "null_embed": null_embed,
        })
        return outputs
