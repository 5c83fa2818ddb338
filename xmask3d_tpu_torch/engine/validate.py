"""In-training validation.

Counterpart of `xmask3d_tpu/engine/validate.py`: the eval forward of each
validation batch, the ensemble and base/novel routing, the 2D branch
without the KD-tree fill (each point its own match), and per-stream IoU
histograms summed on the host into the nine-number summary ({fused, 2d, 3d}
x {mIoU_base, mIoU_novel, hIoU}). The trainer builds the step once and
reuses it every validation pass.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from xmask3d_tpu_torch.engine.infer import ensemble_and_route, fill_and_route_2d
from xmask3d_tpu_torch.utils.metrics import hiou, intersection_and_union

STREAMS = (("pred", ""), ("pred_2d", "_2d"), ("pred_3d", "_3d"))


def make_validate_step(model, cfg):
    """validate_step(batch, statics) -> {stream: (inter, union, target)}
    device histograms. It puts the model in eval mode for the forward and
    restores the mode it found."""
    mc = model.cfg

    @torch.no_grad()
    def validate_step(batch, statics):
        was_training = model.training
        model.eval()
        try:
            outputs = model.eval_forward(batch, statics)
        finally:
            model.train(was_training)
        preds = ensemble_and_route(outputs, mc.base_category, mc.novel_category,
                                   mc.num_test_classes, cfg.base_ratio, cfg.novel_ratio)
        b, p = preds["pred"].shape
        ident = torch.arange(p, dtype=torch.int32, device=preds["pred"].device).expand(b, p)
        preds["pred_2d"] = fill_and_route_2d(
            preds["feat_2d"], ident, preds["binary_pred"].float(), preds["text"],
            preds["logit_scale"], mc.base_category, mc.novel_category)
        return {name: intersection_and_union(
            preds[name], batch["labels_3d"], mc.num_test_classes,
            ignore_index=tuple(mc.ignore_category), valid=batch["point_valid"])
            for name, _ in STREAMS}

    return validate_step


def summarize_validation(hists: Dict[str, tuple], base_category, novel_category
                         ) -> Dict[str, float]:
    out = {}
    for name, tag in STREAMS:
        inter, union, _ = hists[name]
        iou = np.asarray(inter) / np.maximum(np.asarray(union), 1e-10)
        mb = float(iou[list(base_category)].mean())
        mn = float(iou[list(novel_category)].mean())
        out[f"mIoU_base{tag}"] = mb
        out[f"mIoU_novel{tag}"] = mn
        out[f"hIoU{tag}"] = hiou(mb, mn)
    return out


def run_validation(validate_step, statics, batches: Iterable, base_category,
                   novel_category) -> Dict[str, float]:
    """Histograms of every batch, summed on the host, then summarised;
    {} when there is no batch."""
    acc = None
    for batch in batches:
        hists = {k: tuple(t.cpu().numpy() for t in v)
                 for k, v in validate_step(batch, statics).items()}
        acc = hists if acc is None else {k: tuple(a + h for a, h in zip(acc[k], hists[k]))
                                         for k in acc}
    if acc is None:
        return {}
    return summarize_validation(acc, base_category, novel_category)
