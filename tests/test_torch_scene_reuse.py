"""The port's scene reuse (`engine/scene_reuse.py`) against the JAX package.

- `scene_caps_from_view_caps` and `scene_3d_batch`: every array equal.
- `eval_forward(precomp_3d=run_3d(batch))` equals the full eval forward
  bit for bit in the port, and the JAX full eval within the eval golden's
  rtol = atol = 2e-3 (labels exact).
- `run_scene_reuse` on two synthetic scenes, port against JAX with shared
  weights (the reduced tiny model of `test_torch_serve.py`, fp32): every
  stream's per-point predictions exact.
- The CLI with `--scene_reuse` and with `XMASK3D_SCENE_REUSE=1`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmask3d_tpu.engine.scene_reuse as jreuse
from test_torch_model import to_port_batch
from test_torch_serve import SMALL, _tiny_argv, tiny_pair  # noqa: F401 (fixture)
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.data.synthetic import synthetic_scene as jax_synthetic_scene
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_scene
from xmask3d_tpu_torch.engine import infer_cli, scene_reuse
from xmask3d_tpu_torch.engine.graphs import flatten


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tree(jax_tree):
    """A JAX numpy batch dict (hierarchy of lists) as the port's tensors."""
    return to_port_batch(jax.device_get(jax_tree))


def test_scene_capacities_and_scene_batch_equal_jax():
    caps = Capacities(512, 256, 8)
    got_caps = scene_reuse.scene_caps_from_view_caps(caps)
    want_caps = jreuse.scene_caps_from_view_caps(caps, factor=4)
    assert (got_caps.max_points, got_caps.max_voxels, got_caps.level_caps()) == \
        (want_caps.max_points, want_caps.max_voxels, want_caps.level_caps()) == \
        (2048, 1024, (1024, 512, 256, 128, 64))
    scene = synthetic_scene(caps, seed=7, num_points=3000, num_views=1)
    for colors, input_color in ((scene["colors"], True), (None, True), (scene["colors"], False)):
        want = _port_tree(jreuse.scene_3d_batch(scene["coords"], colors, want_caps,
                                                voxel_size=0.05, input_color=input_color))
        got = scene_reuse.scene_3d_batch(scene["coords"], colors, got_caps, voxel_size=0.05,
                                         input_color=input_color, device="cpu")
        assert set(got) == set(want)
        (sg, lg), (_, lw) = flatten(got), flatten({k: want[k] for k in got})
        assert len(lg) == len(lw)
        for g, w in zip(lg, lw):
            np.testing.assert_array_equal(g.numpy(), w.numpy().astype(g.numpy().dtype))
    # more points than the scene capacity: the rest are dropped, not voted
    got = scene_reuse.scene_3d_batch(scene["coords"], None, caps, voxel_size=0.05, device="cpu")
    assert int(got["point_valid"].sum()) <= 512


def test_eval_forward_with_precomp_3d_equals_full_eval(tiny_pair):
    """The trunk with the 3D branch's outputs given equals the one that
    runs it, bit for bit, also from a batch of `VIEW_KEYS` alone; and both
    agree with the JAX full eval."""
    pair = tiny_pair
    batch_np = jax_synthetic_batch(1, pair["caps"], seed=3, num_points=400,
                                   num_classes=pair["jcfg"].classes, **SMALL)
    batch = to_port_batch(batch_np)
    port, st = pair["port"], pair["pstatics"]
    full = port.eval_forward(batch, st)
    reuse = port.eval_forward(batch, st, precomp_3d=port.run_3d(batch))
    # the reuse step's batch: only the view's 2D leaves, no hierarchy
    view_only = port.eval_forward({k: batch[k] for k in scene_reuse.VIEW_KEYS}, st,
                                  precomp_3d=port.run_3d(batch))
    for key, v in full.items():
        if torch.is_tensor(v):
            assert torch.equal(v, reuse[key]), key
            assert torch.equal(v, view_only[key]), key
    model = pair["model"]
    _, want = jax.device_get(jax.jit(lambda v, b, s: model.apply(
        v, b, s, train=False, rngs={"points": jax.random.PRNGKey(0)}))(
        pair["variables"], jax.tree_util.tree_map(jnp.asarray, batch_np), pair["statics"]))
    for key in ("fused_pred_feature", "pred_logits", "binary_sig", "mask_embed_clip"):
        np.testing.assert_allclose(reuse[key].numpy(), want[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    for key in ("pred_labels", "binary_pred", "final_mask_valid"):
        np.testing.assert_array_equal(reuse[key].numpy(), want[key], err_msg=key)


def test_run_scene_reuse_matches_jax(tiny_pair):
    """Two synthetic scenes through both packages' `run_scene_reuse`: every
    stream's per-point predictions exact, every kept view row voted once."""
    pair = tiny_pair
    jcfg, caps = pair["jcfg"], pair["caps"]
    scene_caps = jreuse.scene_caps_from_view_caps(caps)
    jstep3d = jreuse.make_scene_3d_step(pair["model"])
    jinfer, jroute = jreuse.make_reuse_infer_step(pair["model"], jcfg)
    port, pcfg = pair["port"], pair["pcfg"]
    pstep3d = scene_reuse.make_scene_3d_step(port)
    pinfer, proute = scene_reuse.make_reuse_infer_step(port, pcfg)
    pcaps = Capacities(512, 256, 8)
    for seed in (21, 22):
        kw = dict(seed=seed, num_points=1200, num_views=2, num_classes=jcfg.classes, **SMALL)
        want = jreuse.run_scene_reuse(jax_synthetic_scene(caps, **kw), jstep3d, jinfer, jroute,
                                      pair["variables"], pair["statics"], caps, scene_caps,
                                      num_base=jcfg.classes, num_classes=jcfg.test_classes,
                                      voxel_size=0.05)
        record = {}
        got = scene_reuse.run_scene_reuse(
            synthetic_scene(pcaps, **kw), pstep3d, pinfer, proute, pair["pstatics"], pcaps,
            scene_reuse.scene_caps_from_view_caps(pcaps), jcfg.test_classes,
            voxel_size=0.05, device="cpu", record=record)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert record["kept"] > 0 and set(record["counter"].values()) == {record["kept"]}


def test_cli_scene_reuse_flag_and_environment(monkeypatch):
    calls = []
    real = scene_reuse.run_scene_reuse

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(scene_reuse, "run_scene_reuse", spy)
    summary = infer_cli.main(_tiny_argv("--num_scenes", "1", "--scene_reuse"), device="cpu")
    assert np.isfinite(summary["hIoU"]) and len(calls) == 1
    assert not infer_cli.get_parser().parse_args(["--config", "c"]).scene_reuse
    monkeypatch.setenv("XMASK3D_SCENE_REUSE", "1")
    assert infer_cli.get_parser().parse_args(["--config", "c"]).scene_reuse
