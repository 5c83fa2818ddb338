"""The plain reference against the port at tiny size on the CPU (fp32),
for both configurations: one view's eval forward on the same weights and
views (each side voxelizing and building its kernel maps itself), the
served labels through the whole tiny cell, and the training step."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import core
from benchmark.harness.port import draw_tokens, draw_views, port_config, statics_of
from benchmark.harness.refmodel import build_reference, leaf_specs
from benchmark.harness.weights import make_weights
from benchmark.reference.data.collate import collate_views
from benchmark.tests import tiny
from benchmark.traffic.views import VOXEL_SIZE

CONFIGS = ("b15n4", "b170n30")


def _conf(name):
    conf = core.load_json(core.BENCH / "configs" / f"{name}.json")
    return dict(conf, compute_dtype="float32", **tiny.TINY_MODEL)


@pytest.mark.parametrize("config", CONFIGS)
def test_eval_forward_matches_the_port(config):
    from xmask3d_tpu_torch.engine.builder import build_model
    from xmask3d_tpu_torch.engine.graphs import tree_map

    from benchmark.traffic.scene_scan import stage_views

    conf = _conf(config)
    traffic = dict(core.load_json(core.BENCH / "traffic" / "scan_20k.json"),
                   **tiny.TINY_TRAFFIC["scene_scan"])
    seed, dev = 2**31 + 21, torch.device("cpu")
    weights = make_weights(leaf_specs(conf, True, dev), seed, dev)
    port = build_model(port_config(conf, tiny=True), tiny=True, device="cpu")
    port.load_state_dict(weights, strict=True)
    ref = build_reference(conf, seed, dev, tiny=True, weights=weights)
    tokens = draw_tokens(seed, conf, True)
    views = draw_views(seed, conf, traffic, True, 1)
    caps = {"max_points": traffic["max_points"], "max_voxels": traffic["max_voxels"],
            "max_targets": conf["max_targets"]}
    stacked, _ = stage_views(views, caps, dict(traffic, views_per_scene=1), dev)
    pb = tree_map(lambda t: t[0], {k: v for k, v in stacked.items() if k != "vote_point_ids"})
    rb = collate_views(views, caps["max_points"], caps["max_voxels"], caps["max_targets"],
                       VOXEL_SIZE, dev)
    assert torch.equal(pb["point_valid"], rb["point_valid"])
    for a, b in zip(pb["hierarchy"].levels, rb["hierarchy"].levels):
        assert torch.equal(a.kmap3, b.kmap3) and torch.equal(a.coords, b.coords)

    po = port.eval_forward(pb, statics_of(port, tokens, dev))
    ro = ref.eval_forward(rb, statics_of(ref, tokens, dev))
    for k in ("fused_pred_feature", "pred_logits", "binary_scores", "pred_3d",
              "final_pred_open_embedding"):
        a, b = po[k].float(), ro[k].float()
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * max(1.0, b.abs().max().item())), k
    assert torch.equal(po["final_mask_3d"], ro["final_mask_3d"])


@pytest.mark.parametrize("config", CONFIGS)
def test_served_labels_match_the_reference(config):
    """The tiny cell's scan in fp32 gives the reference's labels."""
    code, ctx = tiny.context("b15n4.serve_scan")
    ctx["conf"] = _conf(config)
    record = code.run(ctx)
    checks = code.check(record, ctx)
    assert record["compare"]["program"]["disagree"] == 0.0
    assert record["compare"]["program"]["routed_out"] == 0.0
    assert checks["unvoted_rows"]["value"] == 0
    assert checks["compared_labels"]["value"] > 0


@pytest.mark.parametrize("config", CONFIGS)
def test_training_step_matches_the_reference(config):
    """Three fp32 steps of the port's training step against the reference's
    on the same batches and draws: losses, first gradients and changes.
    The first step's loss and gradients agree to rounding; AdamW's first
    update, lr * g / (|g| + eps), turns the rounding of small gradients into
    whole steps, so the later losses and the changes agree less closely."""
    code, ctx = tiny.context("b170n30.train_b8")
    ctx["conf"] = _conf(config)
    record = code.run(ctx)
    checks = code.check(record, ctx)
    assert record["losses_rel"][0] < 1e-6 and max(record["losses_rel"]) < 1e-3
    got = record["readings"]
    assert got["grad1_leaf"] < 1e-4 and got["grad1_median"] < 1e-5
    assert got["change_leaf"] < 0.1 and got["bn1_leaf"] < 1e-4
