"""Whole-scene inference entry point.

Counterpart of `xmask3d_tpu/engine/infer_cli.py`. Per scene, every accepted
view goes through the eval forward and the ensemble/routing on the device;
the host finds each view's nearest covered point for the 2D branch's fill,
votes the three prediction streams per scene point, fills never-seen points
from their nearest seen one (KD-tree), and keeps the base/novel IoU meters.

    python -m xmask3d_tpu_torch.engine.infer_cli \\
        --config configs/scannet/xmask3d_scannet_B15N4.yaml --synthetic --num_scenes 2

`XMASK3D_FUSED_GN=1` runs the VAE resblocks' GroupNorm -> SiLU -> conv3x3
stages on kernel K4. `--ckpt DIR` serves the newest checkpoint the trainer
wrote there, `--converted NPZ` the released weights converted by
`python -m xmask3d_tpu_torch.tools.convert_checkpoints`, `--bf16_params`
(default from `XMASK3D_BF16_PARAMS`) casts fp32 weights to bf16 values,
`--scene_reuse` (default from `XMASK3D_SCENE_REUSE`) runs the 3D branch once a scene
(`engine/scene_reuse.py`) and `--save_ply DIR` writes each scene's predicted
and ground-truth labels as coloured point clouds. On the GPU every view's forward and routing is one CUDA graph, captured at
the first view and replayed for the others (`engine/graphs.py`);
`main(argv, device="cpu")` runs the same steps eagerly on the CPU with the
plain versions of the kernels.

Under torchrun (`torchrun --nproc_per_node N -m xmask3d_tpu_torch.engine.infer_cli
...`) scene i runs on rank i % N, as the JAX CLI shards, each rank with its
own model and captured graphs, and the IoU meters are summed over the ranks
before the summary (`parallel/mesh.py`).
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
from xmask3d_tpu_torch.engine.graphs import GraphStep, tree_map
from xmask3d_tpu_torch.engine.infer import (
    SceneVoter,
    ensemble_and_route,
    evaluate_scene_predictions,
    fill_and_route_2d,
    nearest_covered_match,
    summarize_iou,
    view_scene_ids,
)
from xmask3d_tpu_torch.parallel.mesh import all_reduce_acc, init_distributed, scenes_of_rank
from xmask3d_tpu_torch.utils.logging import get_logger
from xmask3d_tpu_torch.utils.spans import collect, span

logger = get_logger()
STREAMS = ("pred", "pred_2d", "pred_3d")


def get_parser():
    p = argparse.ArgumentParser("xmask3d_tpu_torch inference")
    p.add_argument("--config", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny model variant (CPU smoke runs)")
    p.add_argument("--ckpt", default="",
                   help="directory of the trainer's checkpoints (<save_path>/model); "
                        "the newest is served")
    p.add_argument("--converted", default="",
                   help="converted-weights npz from "
                        "`python -m xmask3d_tpu_torch.tools.convert_checkpoints`")
    p.add_argument("--num_scenes", type=int, default=0)
    p.add_argument("--save_ply", default="",
                   help="directory for each scene's predicted and ground-truth PLY files")
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit the HashTokenizer fallback on real data "
                        "(from-scratch runs only; incompatible with pretrained CLIP weights)")
    p.add_argument("--scene_reuse", action="store_true",
                   default=os.environ.get("XMASK3D_SCENE_REUSE", "0") == "1",
                   help="voxelize each scene once and reuse its 3D features across views "
                        "(engine/scene_reuse.py; departs from the reference protocol)")
    p.add_argument("--bf16_params", action="store_true",
                   default=os.environ.get("XMASK3D_BF16_PARAMS", "0") == "1",
                   help="serve with bf16 weights, the BatchNorm statistics kept fp32 "
                        "(`cast_params_bf16`; the port already stores the parameters in "
                        "the compute dtype, so under bf16 compute this changes nothing)")
    p.add_argument("opts", nargs="*")
    return p


def make_infer_step(model, cfg):
    """(infer_step, route_2d): one view's eval forward + ensemble/routing
    (a `GraphStep`: a CUDA graph on the card, captured at the first call;
    its `fn` is the eager body), and the 2D branch's fill-and-route, both on
    the model's device. infer_step's outputs are valid until its next call."""
    mc = model.cfg

    @torch.no_grad()
    def infer_body(batch, statics):
        outputs = model.eval_forward(batch, statics)
        return ensemble_and_route(outputs, mc.base_category, mc.novel_category,
                                  mc.num_test_classes, cfg.base_ratio, cfg.novel_ratio)

    route_2d = partial(fill_and_route_2d, base_category=mc.base_category,
                       novel_category=mc.novel_category)
    return GraphStep(infer_body, next(model.parameters()).device), route_2d


def cast_params_bf16(model) -> int:
    """Serving-mode weight cast, the JAX CLI's `--bf16_params`: every fp32
    parameter takes bf16 values; the BatchNorm running statistics (buffers)
    stay as they are. Returns the number of parameters cast.

    `build_model` stores the parameters in the compute dtype, so under bf16
    compute (every shipped config) there is no fp32 parameter and nothing
    changes. Under `compute_dtype float32` the parameters keep their fp32
    storage, since the port's layers compute in their parameters' dtype, and
    take the bf16-rounded values that the JAX model reads after its cast."""
    n = 0
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.copy_(p.to(torch.bfloat16))
                n += 1
    return n


def build_serving_model(cfg, tiny: bool = False, device=None, fused_gn: bool = False,
                        ckpt: str = "", converted: str = "", seed: int = 0,
                        bf16_params: bool = False):
    """The eval model on `device` with weights drawn from `seed`, then the
    newest trainer checkpoint under `ckpt` (its masters in the compute dtype and
    its BatchNorm statistics; the frozen towers keep their built weights,
    as the trainer's restore keeps them) and the converted npz
    `converted`, in that order; with `bf16_params`, `cast_params_bf16` last."""
    dev = resolve_device(device)
    model = build_model(cfg, tiny=tiny, seed=seed, device=dev, fused_gn=fused_gn)
    if ckpt:
        from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer

        meta = Checkpointer(ckpt).restore_for_serving(model)
        logger.info(f"serving checkpoint step {meta['step']} from {ckpt}")
    if converted:
        from xmask3d_tpu_torch.checkpoint.load_converted import apply_converted

        applied_p, applied_s = apply_converted(model, converted)
        logger.info(f"loaded {len(applied_p)} params + {len(applied_s)} batch_stats "
                    f"from {converted}")
    if bf16_params:
        logger.info(f"bf16 weights: {cast_params_bf16(model)} fp32 parameters cast")
    return model


# the host stages of a view in `run_scene`, in order, each the span
# `xm3d.view.<stage>`; "collate" leaves out the hierarchy build (its span
# nests inside), which has its own line
STAGES = ("collate", "hierarchy", "copy_in", "replay", "d2h", "nearest_covered_match",
          "route_2d", "votes")


def run_scene(scene, infer_step, route_2d, statics, caps, num_classes, device=None,
              record: Optional[Dict] = None, builder: str = "native") -> Dict[str, np.ndarray]:
    """Multi-view voting over one scene dict (`ScanNetSceneViews.scene` or
    `synthetic_scene`): the fused-ensemble, 2D-branch and 3D-branch
    per-point predictions, with the per-view nearest-covered fill of the 2D
    features. Each view is collated on the host (its hierarchy built by
    `builder`, "native" or "numpy") and copied in. With `record`, it is
    filled with the view rows that voted ("kept"), each stream's vote count
    ("counter") and each view's host seconds by stage ("host_seconds",
    one list a stage of `STAGES`, gathered from the stages' spans by
    `utils/spans.py` `collect`; on CUDA the device work a stage launches is
    waited for inside it)."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    voters = {k: SceneVoter(len(scene["coords"]), num_classes) for k in STREAMS}
    seconds: Dict[str, List[float]] = {k: [] for k in STAGES}
    kept = 0
    for view in scene["views"]:
        with collect() as t:
            with span("xm3d.view.collate"):
                batch = collate_views([view["sample"]], caps, device="cpu", builder=builder)
                pv = batch["point_valid"][0].numpy()
            with span("xm3d.view.copy_in"):
                batch = tree_map(lambda x: x.to(dev), batch)
                sync()
            with span("xm3d.view.replay"):
                preds = infer_step(batch, statics)
                sync()
            with span("xm3d.view.d2h"):
                covered = preds["covered_2d"][0].cpu().numpy()
            with span("xm3d.view.nearest_covered_match"):
                # view row r holds the r-th visible scene point; vote by the mask
                rows, sids, keep = view_scene_ids(view["visible"], pv)
                coords_p = np.zeros((pv.shape[0], 3), np.float32)
                coords_p[rows] = scene["coords"][sids]
                match = nearest_covered_match(coords_p, covered, pv)
            with span("xm3d.view.route_2d"):
                pred_2d = route_2d(preds["feat_2d"], torch.from_numpy(match)[None].to(dev),
                                   preds["binary_pred"].float(), preds["text"],
                                   preds["logit_scale"])
                sync()
            with span("xm3d.view.d2h"):
                arrs = {k: a[0].cpu().numpy() for k, a in (
                    ("pred", preds["pred"]), ("pred_2d", pred_2d), ("pred_3d", preds["pred_3d"]))}
            with span("xm3d.view.votes"):
                for key, arr in arrs.items():
                    voters[key].add_view(sids[keep], arr[rows[keep]])
                kept += int(keep.sum())
        for stage in STAGES:
            seconds[stage].append(t.get(f"xm3d.view.{stage}", 0.0))
    if record is not None:
        record["kept"] = kept
        record["counter"] = {k: int(v.counter.sum()) for k, v in voters.items()}
        record["host_seconds"] = seconds
    return {k: v.finalize(scene["coords"]) for k, v in voters.items()}


def run_eval_scenes(scene_iter: Iterable[Dict], n: int, *, cfg, caps, statics, infer_step,
                    route_2d, device=None, record: Optional[List[Dict]] = None,
                    scene_reuse: bool = False, scene_3d_step=None, scene_caps=None,
                    save_ply: str = "", builder: str = "native") -> Dict[str, float]:
    """The whole-scene protocol over an iterator of scene dicts: per-view
    forward + routing, multi-view voting, KD-tree fill, and base/novel/hIoU
    meters for the three streams (suffixes "", "_2d", "_3d"), summed over
    the ranks of a process group, plus scenes_per_sec over this process's n
    scenes. With `scene_reuse` each scene goes
    through `run_scene_reuse` (`infer_step` from `make_reuse_infer_step`,
    with `scene_3d_step` and `scene_caps`); otherwise each view's hierarchy
    is built on the host by `builder` (`run_scene`). With `record`, one dict
    a scene is appended: name, views, predictions, its IoU accumulators,
    kept, counter and (not with scene reuse) the host seconds by stage.
    With `save_ply`, each scene's fused predictions and its labels are
    written there as `<name>_pred.ply` and `<name>_gt.ply`."""
    dev = resolve_device(device)
    split = cfg.category_split
    acc = {s: {k: np.zeros(cfg.test_classes, np.float64) for k in ("inter", "union", "target")}
           for s in STREAMS}
    t0 = time.time()
    for scene in scene_iter:
        info: Dict = {}
        if scene_reuse:
            from xmask3d_tpu_torch.engine.scene_reuse import run_scene_reuse

            pred = run_scene_reuse(scene, scene_3d_step, infer_step, route_2d, statics, caps,
                                   scene_caps, cfg.test_classes,
                                   voxel_size=cfg.voxel_size, input_color=cfg.input_color,
                                   device=dev, record=info)
        else:
            pred = run_scene(scene, infer_step, route_2d, statics, caps, cfg.test_classes,
                             device=dev, record=info, builder=builder)
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
        if save_ply:
            from xmask3d_tpu_torch.utils.visualization import save_colored_point_cloud

            save_colored_point_cloud(os.path.join(save_ply, f"{scene['name']}_pred.ply"),
                                     scene["coords"], pred["pred"])
            save_colored_point_cloud(os.path.join(save_ply, f"{scene['name']}_gt.ply"),
                                     scene["coords"], scene["labels"].astype(np.int64))
        logger.info(f"scene {scene['name']} done ({len(scene['views'])} views)")
    dt = time.time() - t0
    acc = all_reduce_acc(acc)
    summary: Dict[str, float] = {}
    for s in STREAMS:
        suffix = "" if s == "pred" else "_" + s.split("_")[1]
        si = summarize_iou(acc[s], split.base_category, split.novel_category)
        summary.update({k + suffix: v for k, v in si.items()})
    summary["scenes_per_sec"] = n / dt
    logger.info(str(summary))
    return summary


def _scannet_scenes(cfg, caps, args):
    """(scene dict iterator, count) of this rank's scenes of the val split
    under cfg.data_root."""
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
    ids = scenes_of_rank(args.num_scenes or len(ds.data_paths))
    return (ds.scene(i) for i in ids), len(ids)


def main(argv=None, device=None):
    args = get_parser().parse_args(argv)
    dev = init_distributed(device)
    cfg = load_config(args.config, args.opts)
    caps = capacities_from_cfg(cfg)
    if not args.synthetic:
        scenes, n = _scannet_scenes(cfg, caps, args)
    fused_gn = os.environ.get("XMASK3D_FUSED_GN", "0") == "1"
    model = build_serving_model(cfg, tiny=args.tiny, device=dev, fused_gn=fused_gn,
                                ckpt=args.ckpt, converted=args.converted,
                                bf16_params=args.bf16_params)
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
        ids = scenes_of_rank(args.num_scenes)
        n = len(ids)
        scenes = (synthetic_scene(caps, seed=100 + i, num_points=1200, num_views=3,
                                  num_classes=cfg.test_classes, **kw2) for i in ids)
    scene_3d_step = scene_caps = None
    if args.scene_reuse:
        from xmask3d_tpu_torch.engine.scene_reuse import (
            make_reuse_infer_step,
            make_scene_3d_step,
            scene_caps_from_view_caps,
        )

        scene_caps = scene_caps_from_view_caps(caps)
        scene_3d_step = make_scene_3d_step(model)
        infer_step, route_2d = make_reuse_infer_step(model, cfg)
        logger.info("scene reuse on: one 3D pass a scene")
    return run_eval_scenes(scenes, n, cfg=cfg, caps=caps, statics=statics, infer_step=infer_step,
                           route_2d=route_2d, device=dev, scene_reuse=args.scene_reuse,
                           scene_3d_step=scene_3d_step, scene_caps=scene_caps,
                           save_ply=args.save_ply)


if __name__ == "__main__":
    main()
