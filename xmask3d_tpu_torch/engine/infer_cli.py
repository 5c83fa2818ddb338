"""Whole-scene inference entry point.

Counterpart of `xmask3d_tpu/engine/infer_cli.py`. Per scene, every accepted
view goes through the eval forward and the ensemble/routing on the device;
the host finds each view's nearest covered point for the 2D branch's fill,
votes the three prediction streams per scene point, fills never-seen points
from their nearest seen one (KD-tree), and keeps the base/novel IoU meters.

    python -m xmask3d_tpu_torch.engine.infer_cli \\
        --config configs/scannet/xmask3d_scannet_B15N4.yaml --synthetic --num_scenes 2

`XMASK3D_FUSED_GN=1` runs the VAE resblocks' GroupNorm -> SiLU -> conv3x3
stages on kernel K4. Runs on the GPU; `main(argv, device="cpu")` runs the
plain versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from functools import partial
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import collate_views
from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.engine.builder import (
    build_model,
    build_statics,
    capacities_from_cfg,
    data_tokenizer,
)
from xmask3d_tpu_torch.engine.infer import (
    SceneVoter,
    ensemble_and_route,
    evaluate_scene_predictions,
    fill_and_route_2d,
    nearest_covered_match,
    summarize_iou,
    view_scene_ids,
)
from xmask3d_tpu_torch.utils.logging import get_logger

logger = get_logger()
STREAMS = ("pred", "pred_2d", "pred_3d")


def get_parser():
    p = argparse.ArgumentParser("xmask3d_tpu_torch inference")
    p.add_argument("--config", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny model variant (CPU smoke runs)")
    p.add_argument("--num_scenes", type=int, default=0)
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit the HashTokenizer fallback on real data "
                        "(from-scratch runs only; incompatible with pretrained CLIP weights)")
    p.add_argument("opts", nargs="*")
    return p


def make_infer_step(model, cfg):
    """(infer_step, route_2d): one view's eval forward + ensemble/routing,
    and the 2D branch's fill-and-route, both on the model's device."""
    mc = model.cfg

    @torch.no_grad()
    def infer_step(batch, statics):
        outputs = model.eval_forward(batch, statics)
        return ensemble_and_route(outputs, mc.base_category, mc.novel_category,
                                  mc.num_test_classes, cfg.base_ratio, cfg.novel_ratio)

    route_2d = partial(fill_and_route_2d, base_category=mc.base_category,
                       novel_category=mc.novel_category)
    return infer_step, route_2d


def run_scene(scene, infer_step, route_2d, statics, caps, num_classes, device=None,
              record: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Multi-view voting over one scene dict (`ScanNetSceneViews.scene` or
    `synthetic_scene`): the fused-ensemble, 2D-branch and 3D-branch
    per-point predictions, with the per-view nearest-covered fill of the 2D
    features. With `record`, it is filled with the view rows that voted
    ("kept") and each stream's vote count ("counter")."""
    dev = resolve_device(device)
    voters = {k: SceneVoter(len(scene["coords"]), num_classes) for k in STREAMS}
    kept = 0
    for view in scene["views"]:
        batch = collate_views([view["sample"]], caps, device=dev)
        preds = infer_step(batch, statics)
        pv = batch["point_valid"][0].cpu().numpy()
        # view row r holds the r-th visible scene point; vote by the mask
        rows, sids, keep = view_scene_ids(view["visible"], pv)
        coords_p = np.zeros((pv.shape[0], 3), np.float32)
        coords_p[rows] = scene["coords"][sids]
        match = nearest_covered_match(coords_p, preds["covered_2d"][0].cpu().numpy(), pv)
        pred_2d = route_2d(preds["feat_2d"], torch.from_numpy(match)[None].to(dev),
                           preds["binary_pred"].float(), preds["text"], preds["logit_scale"])
        for key, arr in (("pred", preds["pred"]), ("pred_2d", pred_2d), ("pred_3d", preds["pred_3d"])):
            voters[key].add_view(sids[keep], arr[0].cpu().numpy()[rows[keep]])
        kept += int(keep.sum())
    if record is not None:
        record["kept"] = kept
        record["counter"] = {k: int(v.counter.sum()) for k, v in voters.items()}
    return {k: v.finalize(scene["coords"]) for k, v in voters.items()}


def run_eval_scenes(scene_iter: Iterable[Dict], n: int, *, cfg, caps, statics, infer_step,
                    route_2d, device=None, record: Optional[List[Dict]] = None) -> Dict[str, float]:
    """The whole-scene protocol over an iterator of scene dicts: per-view
    forward + routing, multi-view voting, KD-tree fill, and base/novel/hIoU
    meters for the three streams (suffixes "", "_2d", "_3d"), plus
    scenes_per_sec over the n scenes. With `record`, one dict a scene is
    appended: name, views, predictions, its IoU accumulators, kept, counter."""
    dev = resolve_device(device)
    split = cfg.category_split
    acc = {s: {k: np.zeros(cfg.test_classes, np.float64) for k in ("inter", "union", "target")}
           for s in STREAMS}
    t0 = time.time()
    for scene in scene_iter:
        info: Dict = {}
        pred = run_scene(scene, infer_step, route_2d, statics, caps, cfg.test_classes,
                         device=dev, record=info)
        per = {}
        for s in STREAMS:
            per[s] = evaluate_scene_predictions(
                pred[s], scene["labels"].astype(np.int64), cfg.test_classes,
                split.base_category, split.novel_category,
                ignore=tuple(cfg.test_ignore_label) + (255,),
            )
            for k in acc[s]:
                acc[s][k] = acc[s][k] + per[s][k]
        if record is not None:
            record.append({"name": scene["name"], "views": len(scene["views"]), "pred": pred,
                           "acc": per, **info})
        logger.info(f"scene {scene['name']} done ({len(scene['views'])} views)")
    dt = time.time() - t0
    summary: Dict[str, float] = {}
    for s in STREAMS:
        suffix = "" if s == "pred" else "_" + s.split("_")[1]
        si = summarize_iou(acc[s], split.base_category, split.novel_category)
        summary.update({k + suffix: v for k, v in si.items()})
    summary["scenes_per_sec"] = n / dt
    logger.info(str(summary))
    return summary


def _scannet_scenes(cfg, caps, args):
    """(scene dict iterator, count) of the val split under cfg.data_root."""
    from xmask3d_tpu_torch.data.scannet import ScanNetConfig, ScanNetSceneViews
    from xmask3d_tpu_torch.data.tokenizer import require_real_tokenizer

    split = cfg.category_split
    ds_cfg = ScanNetConfig(
        data_root=cfg.data_root, data_root_2d=cfg.data_root_2d, caption_path=cfg.caption_path,
        label_2d=cfg.label_2d, base_category=split.base_category,
        novel_category=split.novel_category, ignore_category=split.ignore_category,
        voxel_size=cfg.voxel_size, split="val", scannet200=cfg.scannet200,
    )
    tok = data_tokenizer(cfg, tiny=args.tiny)
    require_real_tokenizer(tok, args.allow_hash_tokenizer)
    ds = ScanNetSceneViews(ds_cfg, caps, tok)
    n = args.num_scenes or len(ds.data_paths)
    return (ds.scene(i) for i in range(n)), n


def main(argv=None, device=None):
    args = get_parser().parse_args(argv)
    dev = resolve_device(device)
    cfg = load_config(args.config, args.opts)
    caps = capacities_from_cfg(cfg)
    if not args.synthetic:
        scenes, n = _scannet_scenes(cfg, caps, args)
    fused_gn = os.environ.get("XMASK3D_FUSED_GN", "0") == "1"
    model = build_model(cfg, tiny=args.tiny, device=dev, fused_gn=fused_gn)
    statics = build_statics(model, cfg, device=dev)
    infer_step, route_2d = make_infer_step(model, cfg)

    if args.synthetic:
        from xmask3d_tpu_torch.data.synthetic import synthetic_batch, synthetic_scene

        kw = {}
        if args.tiny:
            kw = dict(num_points=400, image_size=(64, 64), mask_shape=tuple(cfg.mask_shape),
                      context_length=16, vocab_size=512)
        batch0 = synthetic_batch(1, caps, seed=0, num_classes=cfg.classes, device=dev, **kw)
        preds = infer_step(batch0, statics)
        p_cap = preds["pred"].shape[1]
        pred_2d = route_2d(preds["feat_2d"], torch.arange(p_cap, dtype=torch.int32, device=dev)[None],
                           preds["binary_pred"].float(), preds["text"], preds["logit_scale"])
        logger.info(f"synthetic inference ok: pred shape {tuple(preds['pred'].shape)}, "
                    f"pred_2d shape {tuple(pred_2d.shape)}")
        if not args.num_scenes:
            return None
        # --num_scenes N: the whole-scene protocol over synthetic multi-view scenes
        kw2 = dict(kw) if args.tiny else dict(
            image_size=(512, 512), mask_shape=tuple(cfg.mask_shape), context_length=77,
            vocab_size=49408,
        )
        kw2.pop("num_points", None)
        n = args.num_scenes
        scenes = (synthetic_scene(caps, seed=100 + i, num_points=1200, num_views=3,
                                  num_classes=cfg.test_classes, **kw2) for i in range(n))
    return run_eval_scenes(scenes, n, cfg=cfg, caps=caps, statics=statics, infer_step=infer_step,
                           route_2d=route_2d, device=dev)


if __name__ == "__main__":
    main()
