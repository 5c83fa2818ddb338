"""The port's serving layer (`engine/serve.py`, `engine/graphs.py`) and the
CLI's `--ckpt`, `--converted` and `--save_ply` against the JAX package.

- `resolve_vote_ids` (identity and plumbed ids, scene-reuse gathers and the
  masking of dropped scene rows) and the vote table: exact.
- `stack_scene_views`: every tensor of the stacked tree equals the JAX one.
- `make_scene_scan_step` (the port's counterpart of the JAX scan, run here
  eagerly on the CPU from its static buffers) against the JAX
  `make_scene_scan_step` and against the port's view body dispatched view
  by view, on the shared point table and on a scene's plumbed ids: votes
  exact. The reduced tiny model (MinkUNet14A, 2 decoder and 2 pixel-encoder
  layers, 64x64 images, fp32) carries the JAX weights (every leaf from a
  numpy seed) through `load_jax_variables`.
- `GraphStep`'s buffers: signatures, copies, one entry per signature.
- `--ckpt`: the tiny model trained two steps by the port's trainer, then
  served from its checkpoint: every trainable parameter equals its master
  in the compute dtype, every BatchNorm statistic the trainer's, the frozen
  towers their built weights.
- `--converted`: an npz in `scripts/convert_checkpoints.py`'s key format,
  holding part of another draw of the JAX tiny model's variables and a key
  with no destination, applied to a port model: equal to
  `load_jax_variables` of the JAX tree after the JAX `apply_converted`.
- `--save_ply`: the files parse, one vertex a scene point, coloured by the
  label palette.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmask3d_tpu.checkpoint.load_converted as jconv
from test_torch_model import random_variables, to_port_batch
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.data.synthetic import synthetic_scene as jax_synthetic_scene
from xmask3d_tpu.engine import serve as jserve
from xmask3d_tpu.engine.builder import data_tokenizer, model_config_from_cfg, zero_statics
from xmask3d_tpu.engine.infer import device_vote_add as jax_device_vote_add
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.checkpoint.load_converted import apply_converted
from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_scene
from xmask3d_tpu_torch.engine import infer_cli, serve
from xmask3d_tpu_torch.engine import train as trainer
from xmask3d_tpu_torch.engine.builder import build_model, label_tree
from xmask3d_tpu_torch.engine.graphs import GraphStep, copy_into, flatten, tree_map
from xmask3d_tpu_torch.engine.infer import device_vote_add

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
REDUCED = {"arch_3d": "MinkUNet14A", "arch_binary_head": "MinkUNet14A", "mask_shape": [24, 32],
           "compute_dtype": "float32", "max_points": 512, "max_voxels": 256, "max_targets": 8,
           "dec_layers": 2, "pixel_enc_layers": 2}
SMALL = dict(image_size=(64, 64), mask_shape=(24, 32), context_length=16, vocab_size=512)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(loader):
    cfg = loader(CONFIG)
    cfg.update(REDUCED)
    return cfg


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# vote ids and the vote table
# --------------------------------------------------------------------------


def test_resolve_vote_ids_identity_and_plumbed():
    pv = np.array([[True, True, False, True]])
    vp = np.array([[7, 3, -1, 2]], np.int32)
    for batch in ({"point_valid": pv}, {"point_valid": pv, "vote_point_ids": vp}):
        want = jserve.resolve_vote_ids({k: jnp.asarray(v) for k, v in batch.items()})
        got = serve.resolve_vote_ids({k: _t(v) for k, v in batch.items()})
        assert got[2] is None and want[2] is None
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_resolve_vote_ids_masks_invalid_scene_rows():
    """Ids beyond the scene table and ids of dropped scene points are not
    voted; the gathers stay in range (clamped)."""
    pv = np.ones((1, 5), bool)
    vp = np.array([[0, 2, 9, -1, 3]], np.int32)
    scene3d = {"imp_condition": np.arange(8, dtype=np.float32)[None],
               "pred_3d": np.arange(8, dtype=np.float32).reshape(1, 4, 2),
               "binary_scores": np.array([[0.0, 1.0, 2.0, 3.0]], np.float32),
               "point_valid": np.array([[True, True, False, True]])}
    for with_pv in (True, False):
        s3 = {k: v for k, v in scene3d.items() if with_pv or k != "point_valid"}
        want = jserve.resolve_vote_ids({"point_valid": jnp.asarray(pv),
                                        "vote_point_ids": jnp.asarray(vp)},
                                       {k: jnp.asarray(v) for k, v in s3.items()})
        got = serve.resolve_vote_ids({"point_valid": _t(pv), "vote_point_ids": _t(vp)},
                                     {k: _t(v) for k, v in s3.items()})
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert set(got[2]) == set(want[2])
        for k in want[2]:
            np.testing.assert_array_equal(got[2][k].numpy(), np.asarray(want[2][k]))
    np.testing.assert_array_equal(got[1].numpy(), [[True, True, False, False, True]])


def test_votes_with_plumbed_ids_land_on_scene_rows():
    votes = (torch.zeros((6, 3), dtype=torch.int32), torch.zeros((6,), dtype=torch.int32))
    jvotes = (jnp.zeros((6, 3), jnp.int32), jnp.zeros((6,), jnp.int32))
    for vp, preds in (([4, 1], [0, 2]), ([1, 5], [2, 1]), ([-1, 7], [1, 1])):
        batch = {"point_valid": np.array([[True, True]]), "vote_point_ids": np.array([vp], np.int32)}
        ids, valid, _ = serve.resolve_vote_ids({k: _t(v) for k, v in batch.items()})
        votes = device_vote_add(*votes, ids.reshape(-1), torch.tensor(preds), valid.reshape(-1))
        jids, jvalid, _ = jserve.resolve_vote_ids({k: jnp.asarray(v) for k, v in batch.items()})
        jvotes = jax_device_vote_add(*jvotes, jids.reshape(-1), jnp.asarray(preds, jnp.int32),
                                     jvalid.reshape(-1))
    for g, w in zip(votes, jvotes):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(votes[1].numpy(), [0, 2, 0, 0, 1, 1])


# --------------------------------------------------------------------------
# the static buffers of a GraphStep
# --------------------------------------------------------------------------


def test_graph_step_buffers_on_the_cpu():
    """On the CPU a GraphStep runs its function eagerly on static copies of
    the arguments: the caller's tensors are never written (the vote state
    accumulates in the step's own buffers), one entry is kept per
    signature, and trees that differ in shape are refused by `copy_into`."""
    calls = []

    def fn(batch, votes):
        calls.append(batch["x"].data_ptr())
        votes.add_(batch["x"].sum())
        return {"y": batch["x"] * 2, "votes": votes}

    step = GraphStep(fn, "cpu")
    votes = torch.zeros(())
    a = {"x": torch.arange(3.0), "h": (torch.ones(2), 5)}
    out = step(a, votes)
    assert float(votes) == 0.0 and float(out["votes"]) == 3.0
    b = {"x": torch.arange(3.0) + 1, "h": (torch.ones(2), 5)}
    out = step(b, votes)
    assert torch.equal(out["y"], b["x"] * 2) and float(out["votes"]) == 6.0
    assert calls[0] == calls[1] != a["x"].data_ptr()
    step({"x": torch.arange(4.0), "h": (torch.ones(2), 5)}, votes)
    step({"x": torch.arange(3.0), "h": (torch.ones(2), 6)}, votes)
    assert len(step._steps) == 3 and step.graphs == 0
    with pytest.raises(ValueError):
        copy_into(step.inputs, ({"x": torch.arange(5.0), "h": (torch.ones(2), 6)}, votes))
    sig, leaves = flatten(b)
    assert len(leaves) == 2 and flatten(tree_map(torch.clone, b))[0] == sig
    with pytest.raises(ValueError, match="must be on"):
        GraphStep(fn, "cpu")({"x": torch.zeros(1, device="meta")}, votes)


# --------------------------------------------------------------------------
# stacked scene views and the scene scan, port against JAX
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = _cfg(jax_load_config)
    caps = JaxCapacities(max_points=512, max_voxels=256, max_targets=8)
    batch0 = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(
        1, caps, seed=0, num_points=400, num_classes=jcfg.classes, **SMALL))
    model = JaxXMask3D(cfg=model_config_from_cfg(jcfg, tiny=True))
    rngs = {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(partial(model.init, train=True), rngs, batch0,
                            zero_statics(model, jcfg))
    variables = random_variables({"params": shapes["params"],
                                  "batch_stats": shapes["batch_stats"]}, seed=11)
    tok = data_tokenizer(jcfg, tiny=True)
    bank = jax.jit(lambda v, t: model.apply(v, t, method=lambda m, x: m.embed_captions(x)))
    statics = {"text_embed_train": bank(variables, jnp.asarray(tok(list(jcfg.label)))),
               "text_embed_test": bank(variables, jnp.asarray(tok(list(jcfg.all_label)))),
               "uncond_tokens": jnp.asarray(tok([""]))}
    pcfg = _cfg(load_config)
    port = build_model(pcfg, tiny=True, device="cpu")
    load_jax_variables(port, jax.device_get(variables))
    return {"jcfg": jcfg, "pcfg": pcfg, "caps": caps, "model": model, "variables": variables,
            "statics": statics, "port": port,
            "pstatics": {k: _t(v) for k, v in statics.items()},
            "scan": jserve.make_scene_scan_step(model, jcfg)}


def _jax_stacked_to_port(stacked):
    """The JAX stacked numpy tree as the port's (hierarchy as dataclasses)."""
    return to_port_batch(jax.device_get(stacked))


def _scene(seed, caps, cfg, jax_side):
    fn = jax_synthetic_scene if jax_side else synthetic_scene
    return fn(caps, seed=seed, num_points=900, num_views=3, num_classes=cfg.classes, **SMALL)


def test_stack_scene_views_equals_jax(tiny_pair):
    jcfg = tiny_pair["jcfg"]
    want, want_idx, want_n = jserve.stack_scene_views(_scene(5, tiny_pair["caps"], jcfg, True),
                                                      tiny_pair["caps"], num_base=jcfg.classes)
    got, idx, n = serve.stack_scene_views(_scene(5, Capacities(512, 256, 8), jcfg, False),
                                          Capacities(512, 256, 8), jcfg.classes, device="cpu")
    assert n == want_n == 900
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want = _jax_stacked_to_port(want)
    assert set(got) <= set(want)
    want = {k: want[k] for k in got}
    (sg, lg), (sw, lw) = flatten(got), flatten(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy().astype(g.numpy().dtype))
    ids = got["vote_point_ids"].numpy()
    assert ids.max() < n and (ids >= 0).any()


def _jax_scan(pair, stacked, n):
    jstatics = pair["statics"]
    return jax.device_get(pair["scan"](pair["variables"], stacked,
                                       jnp.arange(stacked["point_valid"].shape[0]), jstatics,
                                       *jserve.fresh_vote_state(n, 19)))


@pytest.mark.parametrize("plumbed", [False, True])
def test_scene_scan_matches_jax_and_per_view_dispatch(tiny_pair, plumbed):
    """Votes of the port's scan (its static buffers, eager on the CPU) equal
    the JAX scan's and the port's view body dispatched view by view: on
    three synthetic views sharing one point table, and on a scene's views
    with their scene point ids plumbed."""
    jcfg, caps = tiny_pair["jcfg"], tiny_pair["caps"]
    if plumbed:
        jstacked, _, n = jserve.stack_scene_views(_scene(6, caps, jcfg, True), caps,
                                                  num_base=jcfg.classes)
        stacked, idxseq, _ = serve.stack_scene_views(_scene(6, Capacities(512, 256, 8), jcfg,
                                                            False), Capacities(512, 256, 8),
                                                     jcfg.classes, device="cpu")
    else:
        views = [jax_synthetic_batch(1, caps, seed=s, num_points=400, num_classes=jcfg.classes,
                                     **SMALL) for s in (0, 1, 2)]
        jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                                          *views)
        stacked = serve.stack_views([to_port_batch(v) for v in views])
        idxseq, n = torch.arange(3), 512
    want = _jax_scan(tiny_pair, jstacked, n)
    port, pstatics = tiny_pair["port"], tiny_pair["pstatics"]
    scan = serve.make_scene_scan_step(port, tiny_pair["pcfg"], device="cpu")
    votes0 = serve.fresh_vote_state(n, 19, device="cpu")
    got = scan(stacked, idxseq, pstatics, *votes0)
    assert int(votes0[1].sum()) == 0  # the arguments stay as they were
    body = serve.make_view_body(port, tiny_pair["pcfg"], device="cpu")
    each = serve.fresh_vote_state(n, 19, device="cpu")
    for v in idxseq.tolist():
        each = body(tree_map(lambda t: t[v], stacked), pstatics, *each)
    for g, e, w in zip(got, each, want):
        np.testing.assert_array_equal(g.numpy(), e.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0
    # a repeated index replays the same view again (a bounded view buffer)
    again = scan(stacked, [0, 0], pstatics, *votes0)
    twice = body(tree_map(lambda t: t[0], stacked), pstatics,
                 *body(tree_map(lambda t: t[0], stacked), pstatics,
                       *serve.fresh_vote_state(n, 19, device="cpu")))
    for g, w in zip(again, twice):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(IndexError):
        scan(stacked, [3], pstatics, *votes0)
    with pytest.raises(ValueError, match="scene3d"):
        scan(stacked, idxseq, pstatics, *votes0, scene3d={})


# --------------------------------------------------------------------------
# the CLI: --ckpt, --converted, --save_ply
# --------------------------------------------------------------------------


def _tiny_argv(*extra):
    opts = []
    for k, v in REDUCED.items():
        opts += [k, str(v).replace(" ", "")]
    return ["--config", CONFIG, "--synthetic", "--tiny", *extra, *opts]


def test_cli_serves_the_trainers_checkpoint(tmp_path):
    """Two training steps of the tiny model, then `--ckpt`: the served
    model holds the trainer's masters (in the compute dtype) and BatchNorm
    statistics, and the frozen towers their built weights."""
    save = tmp_path / "run"
    trainer.main(["--config", CONFIG, "--synthetic", "--tiny", "--save_path", str(save),
                  *sum(([k, str(v).replace(" ", "")] for k, v in REDUCED.items()), []),
                  "batch_size", "2", "epochs", "1", "steps_per_epoch", "2", "evaluate", "False"],
                 device="cpu")
    ckpt_dir = str(save / "model")
    assert Checkpointer(ckpt_dir).latest_step() == 2
    cfg = _cfg(load_config)
    built = build_model(cfg, tiny=True, device="cpu")
    served = infer_cli.build_serving_model(cfg, tiny=True, device="cpu", ckpt=ckpt_dir)
    payload = torch.load(os.path.join(ckpt_dir, "step_2.pt"), weights_only=True)
    labels = label_tree(served)
    params, frozen = dict(served.named_parameters()), dict(built.named_parameters())
    moved = 0
    for name, p in params.items():
        if labels[name] == "frozen":
            assert torch.equal(p, frozen[name]), name
            continue
        master = payload["trainable"][name]
        assert master.dtype == torch.float32
        assert torch.equal(p, master.to(p.dtype)), name
        moved += not torch.equal(p, frozen[name])
    assert moved > 100
    for name, b in served.named_buffers():
        assert torch.equal(b, payload["batch_stats"][name]), name
    summary = infer_cli.main(_tiny_argv("--num_scenes", "1", "--ckpt", ckpt_dir), device="cpu")
    assert np.isfinite(summary["hIoU"])


def test_cli_loads_converted_weights(tmp_path, tiny_pair):
    """`--converted`: a partial npz of another draw of the JAX variables
    (the 3D UNets, the mask decoder and the BatchNorm statistics, plus a
    name with no destination, which is skipped) applied to the port equals
    the bridge of the JAX tree after the JAX `apply_converted`; a misshapen
    tensor raises."""
    base = jax.device_get(tiny_pair["variables"])
    other = jax.device_get(random_variables(jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.float32), base), seed=12))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
        return out

    params = {k: v for k, v in flat(other["params"]).items()
              if k.startswith(("pc_decoder/", "pc_binary_head/", "mask_decoder/"))}
    stats = flat(other["batch_stats"])
    params["mask_decoder/aux_layer_99/kernel"] = np.zeros((2, 2), np.float32)
    path = tmp_path / "converted.npz"
    np.savez(path, **{f"params/{k}": v for k, v in params.items()},
             **{f"batch_stats/{k}": v for k, v in stats.items()})

    want_tree, applied_p, applied_s = jconv.apply_converted(
        jax.tree_util.tree_map(np.array, base), str(path))
    want = build_model(tiny_pair["pcfg"], tiny=True, device="cpu")
    load_jax_variables(want, want_tree)
    got = build_model(tiny_pair["pcfg"], tiny=True, device="cpu")
    load_jax_variables(got, base)
    got_p, got_s = apply_converted(got, str(path))
    assert sorted(got_p) == sorted(applied_p) and sorted(got_s) == sorted(applied_s)
    assert len(got_p) == len(params) - 1
    for (n, a), (_, b) in zip(got.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), n
    assert "mask_decoder/aux_layer_99/kernel" not in got_p  # no destination: skipped
    np.savez(path, **{"params/pc_decoder/decoder/kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        apply_converted(got, str(path))


def test_cli_converted_and_save_ply(tmp_path):
    """The CLI with `--converted` (an npz of the port model's own 3D UNet
    weights, written back under their JAX names) and `--save_ply`: the
    summary is finite and every scene leaves two PLY files that parse."""
    cfg = _cfg(load_config)
    model = build_model(cfg, tiny=True, device="cpu")
    sd = model.state_dict()
    npz = {"params/pc_decoder/decoder/kernel": sd["pc_decoder.decoder.weight"].numpy().T,
           "batch_stats/pc_binary_head/bn/var": np.full_like(sd["pc_binary_head.bn.var"].numpy(),
                                                             2.0)}
    np.savez(tmp_path / "w.npz", **npz)
    ply = tmp_path / "ply"
    summary = infer_cli.main(_tiny_argv("--num_scenes", "2", "--converted",
                                        str(tmp_path / "w.npz"), "--save_ply", str(ply)),
                             device="cpu")
    assert np.isfinite(summary["hIoU"])
    files = sorted(os.listdir(ply))
    assert files == ["synthetic_100_gt.ply", "synthetic_100_pred.ply",
                     "synthetic_101_gt.ply", "synthetic_101_pred.ply"]
    for f in files:
        with open(ply / f) as fh:
            lines = fh.read().splitlines()
        end = lines.index("end_header")
        n = int(lines[2].split()[-1])
        assert lines[:2] == ["ply", "format ascii 1.0"] and len(lines) == end + 1 + n == end + 1201
        rows = np.array([ln.split() for ln in lines[end + 1:]], np.float64)
        assert rows.shape == (1200, 6) and np.isfinite(rows).all()
        assert ((rows[:, 3:] >= 0) & (rows[:, 3:] <= 255)).all()
