"""Scene-inference serving step: one view's forward + routing + vote.

Counterpart of `make_view_body` in `xmask3d_tpu/engine/serve.py`. The JAX
package scans the view loop inside one device program; here the caller's
Python loop over a scene's views calls the view body, with the vote state
on the device for the whole scene.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.engine.infer import device_vote_add, ensemble_and_route

Votes = Tuple[torch.Tensor, torch.Tensor]


def make_view_body(model, cfg, device=None) -> Callable[..., Votes]:
    """view_body(batch, statics, votes, counter) -> (votes, counter).

    `model` and every tensor given to the body live on `device` (the GPU
    unless "cpu" is asked for). Without `vote_point_ids` in the batch each
    row votes under its own index (one shared point table per scene); with
    it, -1 marks padding."""
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"model is not on {dev}")
    mc = model.cfg

    @torch.no_grad()
    def view_body(batch: Dict[str, Any], statics, votes, counter) -> Votes:
        if batch["img"].device != dev or votes.device != dev:
            raise ValueError(f"batch and vote state must be on {dev}")
        pv = batch["point_valid"]
        ids = batch.get("vote_point_ids")
        if ids is None:
            ids = torch.arange(pv.shape[1], device=dev).expand_as(pv)
        outputs = model.eval_forward(batch, statics)
        routed = ensemble_and_route(
            outputs, mc.base_category, mc.novel_category, mc.num_test_classes,
            cfg.base_ratio, cfg.novel_ratio,
        )
        return device_vote_add(
            votes, counter, ids.reshape(-1), routed["pred"].reshape(-1), pv.reshape(-1)
        )

    return view_body


def fresh_vote_state(max_points: int, num_classes: int, device=None) -> Votes:
    dev = resolve_device(device)
    return (
        torch.zeros((max_points, num_classes), dtype=torch.int32, device=dev),
        torch.zeros((max_points,), dtype=torch.int32, device=dev),
    )
