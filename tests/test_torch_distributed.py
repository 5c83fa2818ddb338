"""Data parallelism across processes (`xmask3d_tpu_torch/parallel/mesh.py`)
on the CPU: two ranks spawned over gloo (`tests/torch_dist_worker.py`,
which fails a test whose ranks have not ended within 180 s), one torch
thread each.

- `rows_of_rank` / `scenes_of_rank`: the rank's rows and scenes.
- A synced `MaskedBatchNorm` on two ranks with unequal valid voxels equals
  one process on the whole batch: outputs, the input's gradient and the
  running statistics within 1e-6, the parameters' gradients summed over the
  ranks within 1e-5.
- The reduced tiny model's train step at 2 ranks x 1 sample against the
  port at batch 2 and the JAX package's `make_train_step` at batch 2
  (`test_torch_train.py`'s tolerances: losses 2e-4, each trainable leaf's
  gradient 1e-2 relative L2 and 3e-2 of its largest value, running
  statistics 1e-5), on two samples with unequal numbers of valid masks (4
  and 3), valid points (400 and 300) and flagged masks (one view all novel,
  the other all base, so `loss_3d_contra` is live); both ranks end with
  the same moments and statistics, bit for bit.
- `run_eval_scenes` on 2 ranks x 1 scene: the summed meters equal one
  process's on the 2 scenes exactly, and JAX's `run_eval_scenes` within
  the points on which the two packages' predictions disagree (the rule of
  `test_torch_infer_cli.py`).
- Validation on 2 ranks (each its row of every batch) equals one process.
- The trainer's real-data stream (the miniature ScanNet, serial and with
  prefetch workers) gives each rank its rows of the one-process batches.
- The trainer's CLI on 2 ranks: only rank 0 writes checkpoints and
  metrics, both ranks report the same metrics, and its losses equal one
  process's within 2e-4.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_infer_cli import CONFIG, STREAMS, scenes_both  # noqa: F401 (a fixture)
from test_torch_infer_cli import SCENE_CAPS
from mini_scannet import build_mini_scannet
from test_torch_model import TINY, to_port_batch
from test_torch_train import (
    GRAD_L2_TOL,
    GRAD_MAX_TOL,
    GRAD_ZERO_TOL,
    LOSS_TOL,
    REDUCED,
    STATS_TOL,
    TOTAL_STEPS,
    _leaves,
    _tiny_argv,
    jax_and_port_step,
    synthetic_train_batch,
)
from torch_dist_worker import spawn_ranks
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine import train as trainer
from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, capacities_from_cfg
from xmask3d_tpu_torch.engine.validate import make_validate_step, run_validation
from xmask3d_tpu_torch.models.minkunet import MaskedBatchNorm
from xmask3d_tpu_torch.parallel import mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_rank(monkeypatch, r, w):
    monkeypatch.setattr(mesh, "rank", lambda: r)
    monkeypatch.setattr(mesh, "world_size", lambda: w)


def test_rows_and_scenes_of_rank(monkeypatch):
    x = torch.arange(24).reshape(6, 4)
    batch = {"a": x, "h": (x, None), "list": list(range(6))}
    assert mesh.rows_of_rank(batch)["list"] == list(range(6))  # no group: everything
    assert mesh.scenes_of_rank(5) == [0, 1, 2, 3, 4]
    for r in range(3):
        _as_rank(monkeypatch, r, 3)
        got = mesh.rows_of_rank(batch)
        assert torch.equal(got["a"], x[2 * r:2 * r + 2]) and got["h"][1] is None
        assert torch.equal(got["h"][0], x[2 * r:2 * r + 2])
        assert got["list"] == [2 * r, 2 * r + 1]
        assert mesh.scenes_of_rank(7) == [i for i in range(7) if i % 3 == r]
    _as_rank(monkeypatch, 1, 2)
    assert torch.equal(mesh.rows_of_rank(x, dim=1), x[:, 2:])
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows_of_rank(torch.zeros(3, 2))


def test_synced_batchnorm_equals_one_process(tmp_path):
    rng = np.random.RandomState(0)
    c = 16
    x = torch.from_numpy(rng.randn(2, 40, c).astype(np.float32) * 2 + 1)
    valid = torch.zeros(2, 40, dtype=torch.bool)
    valid[0, :37] = True
    valid[1, :11] = True
    g = torch.from_numpy(rng.randn(2, 40, c).astype(np.float32))
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
        bn.mean.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
    torch.save({"x": x, "valid": valid, "g": g, "state": bn.state_dict()}, tmp_path / "bn_in.pt")
    xr = x.clone().requires_grad_()
    y = bn(xr, valid)
    (y * g).sum().backward()
    ranks = spawn_ranks("batchnorm", tmp_path)
    for r, out in enumerate(ranks):
        rows = slice(r, r + 1)
        torch.testing.assert_close(out["y"], y.detach()[rows], rtol=0, atol=1e-6)
        torch.testing.assert_close(out["x_grad"], xr.grad[rows], rtol=0, atol=1e-6)
        torch.testing.assert_close(out["mean"], bn.mean, rtol=0, atol=1e-6)
        torch.testing.assert_close(out["var"], bn.var, rtol=0, atol=1e-6)
    for name in ("scale_grad", "bias_grad"):
        want = getattr(bn, name.split("_")[0]).grad
        torch.testing.assert_close(ranks[0][name] + ranks[1][name], want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def unequal_step():
    """The JAX and port steps at batch 2 on two views with 4 and 3 valid
    masks, 400 and 300 valid points, one all novel and one all base."""
    batch_np = synthetic_train_batch()
    batch_np["point_valid"][1, 300:] = False
    assert batch_np["target_valid"].sum(1).tolist() == [4, 3]
    assert batch_np["point_valid"].sum(1).tolist() == [400, 300]
    return jax_and_port_step(batch_np)


def test_train_step_on_two_ranks_equals_one_process_and_jax(unequal_step, tmp_path):
    import jax

    from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables

    pcfg = load_config(CONFIG)
    pcfg.update(REDUCED)
    start = build_train_model(pcfg, tiny=True, device="cpu")
    load_jax_variables(start, jax.device_get(unequal_step["variables"]))
    torch.save({"state": start.state_dict(), "batch": to_port_batch(unequal_step["batch_np"]),
                "statics": unequal_step["statics"], "draws": unequal_step["draws"],
                "total_steps": TOTAL_STEPS}, tmp_path / "step_in.pt")
    ranks = spawn_ranks("train_step", tmp_path, (REDUCED,))

    one, jax_metrics = unequal_step["port"], unequal_step["jax"]
    got = ranks[0]["metrics"]
    assert float(jax_metrics["loss_3d_contra"]) > 0
    for k, want in one.items():
        if k.startswith("grad_norm"):
            continue
        torch.testing.assert_close(ranks[1]["metrics"][k], got[k], rtol=0, atol=0, msg=k)
        if k.startswith("metric_"):
            assert torch.equal(got[k], want), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jax_metrics[k]), err_msg=k)
            continue
        for ref in (want.numpy(), np.asarray(jax_metrics[k])):
            np.testing.assert_allclose(got[k].numpy(), ref, rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=k)

    # gradients: AdamW's first moment after the step, (1 - b1) * grad
    state = unequal_step["state"]
    adam = state.optimizer.adamw.state
    groups = {id(p): g for g, pairs in state.optimizer.pairs.items() for p, _ in pairs}
    mu0, mu1 = ranks[0]["mu"], ranks[1]["mu"]
    top = max(float(v.abs().max()) for v in mu0.values())
    checked = 0
    for name, t, col, path, fn in _leaves(state.model):
        if col != "params" or id(t) not in groups:
            continue
        assert torch.equal(mu0[name], mu1[name]), name
        jax_mu = unequal_step["mu"][groups[id(t)]][path]
        for want in (adam[t]["exp_avg"].numpy(), fn(jax_mu) if fn is not None else jax_mu):
            g = mu0[name].numpy()
            if name.endswith("k_proj.bias"):
                assert max(np.abs(g).max(), np.abs(want).max()) <= GRAD_ZERO_TOL * top, name
                continue
            l2 = float(np.linalg.norm(g - want) / np.linalg.norm(want))
            worst = float(np.abs(g - want).max() / np.abs(want).max())
            assert l2 <= GRAD_L2_TOL and worst <= GRAD_MAX_TOL, f"{name}: L2 {l2}, max {worst}"
        checked += 1
    assert checked == len(mu0) > 100

    for name, t, col, path, fn in _leaves(state.model):
        if col == "batch_stats":
            b0, b1 = ranks[0]["buffers"][name], ranks[1]["buffers"][name]
            assert torch.equal(b0, b1), name
            for want in (t.numpy(), unequal_step["stats"][path]):
                np.testing.assert_allclose(b0.numpy(), want, rtol=0, atol=STATS_TOL, err_msg=name)


def test_run_eval_scenes_on_two_ranks_sums_the_meters(scenes_both, tmp_path):  # noqa: F811
    cfg = dict(TINY, **SCENE_CAPS)
    torch.save({"state": scenes_both["port"].state_dict(), "statics": scenes_both["statics"],
                "scene_kw": scenes_both["scene_kw"]}, tmp_path / "eval_in.pt")
    ranks = spawn_ranks("eval", tmp_path, (cfg, 2))
    assert [r["ids"] for r in ranks] == [[0], [1]]
    one = scenes_both["got"]
    for r in ranks:
        assert set(r["summary"]) == set(one)
        for k, v in one.items():
            if k != "scenes_per_sec":
                assert r["summary"][k] == v, k
    record, jax_accs = scenes_both["record"], scenes_both["jax_accs"]
    for s in STREAMS:
        n_dis = sum(int((rec["pred"][s] != scenes_both["jax_preds"][i][s]).sum())
                    for i, rec in enumerate(record))
        for k in ("inter", "union", "target"):
            summed = ranks[0]["acc"][0][s][k] + ranks[1]["acc"][0][s][k]
            np.testing.assert_array_equal(summed, record[0]["acc"][s][k] + record[1]["acc"][s][k])
            want = sum(jax_accs[3 * i + STREAMS.index(s)][k] for i in range(2))
            assert np.abs(summed - want).max() <= n_dis, (s, k)


def test_validation_on_two_ranks_equals_one_process(tmp_path):
    cfg = load_config(CONFIG)
    cfg.update(REDUCED)
    model = build_train_model(cfg, tiny=True, seed=3, device="cpu")
    statics = build_statics(model, cfg, device="cpu")
    caps = capacities_from_cfg(cfg)
    batches = [synthetic_batch(2, caps, seed=50 + i, num_points=400, image_size=(64, 64),
                               mask_shape=(24, 32), context_length=16, vocab_size=512,
                               device="cpu") for i in range(2)]
    torch.save({"state": model.state_dict(), "statics": statics, "batches": batches},
               tmp_path / "val_in.pt")
    split = cfg.category_split
    want = run_validation(make_validate_step(model, cfg), statics, batches,
                          split.base_category, split.novel_category)
    ranks = spawn_ranks("validation", tmp_path, (REDUCED,))
    assert want and ranks[0] == want and ranks[1] == want


def test_trainer_on_two_ranks_writes_only_on_rank_zero(tmp_path):
    argv = _tiny_argv(tmp_path / "one")
    one = trainer.main(argv, device="cpu")
    i = argv.index("--save_path")
    ranks = spawn_ranks("trainer", tmp_path, (argv[:i] + argv[i + 2:],), timeout=180.0)
    assert ranks[0] == ranks[1]
    # the metrics file's name holds the time: compare what lies under each
    walk = {d: sorted((os.path.relpath(root, tmp_path / d).count(os.sep), len(files))
                      for root, _, files in os.walk(tmp_path / d)) for d in ("run_0", "one")}
    assert walk["run_0"] == walk["one"] and os.listdir(tmp_path / "run_0" / "model")
    assert not [f for _, _, files in os.walk(tmp_path / "run_1") for f in files]
    assert ranks[0]["step"] == one["step"] == 2
    for k, v in one["last_metrics"].items():
        if k.startswith("loss"):
            np.testing.assert_allclose(ranks[0]["last_metrics"][k], v, rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)


def _tensors(tree):
    if tree is None:  # a hierarchy level's brick metadata, when built without
        return []
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [t for f in sorted(vars(tree)) for t in _tensors(getattr(tree, f))]


@pytest.mark.parametrize("workers", [0, 2])
def test_real_data_batches_of_a_rank_are_its_rows(tmp_path, monkeypatch, workers):
    root = build_mini_scannet(tmp_path, n_views=4)
    cfg = load_config(CONFIG)
    cfg.update(data_root=str(root / "scannet_3d"), data_root_2d=str(root / "scannet_2d"),
               caption_path=str(root / "caption.json"), loop=4, batch_size=2, workers=workers)

    def batches():
        data, _, _ = trainer.make_data_iter(cfg, Capacities(2048, 2048, 8), synthetic=False,
                                            tiny=True, allow_hash_tokenizer=True, device="cpu")
        out = [next(data) for _ in range(2)]
        data.close()
        return out

    whole = batches()
    for r in range(2):
        _as_rank(monkeypatch, r, 2)
        for got, full in zip(batches(), whole):
            want = _tensors(mesh.rows_of_rank(full))
            got = _tensors(got)
            assert len(got) == len(want) and got[0].shape[0] == 1
            assert all(torch.equal(a, b) for a, b in zip(got, want))
