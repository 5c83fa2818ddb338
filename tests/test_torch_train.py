"""The port's training step and trainer against the JAX package.

One reduced tiny configuration (the one `scripts/train_step_tpu.py` uses:
MinkUNet14A for both 3D nets, 2 decoder layers, 2 pixel-encoder layers,
ViT-tiny, LDM_TINY, mask shape (24, 32), capacities 512/256/8, float32, a
batch of two 64x64 views) with every JAX leaf drawn from a numpy seed and
carried into the port by `load_jax_variables`. The JAX package's
`make_train_step` runs once (jitted) in a module fixture that keeps numpy
results; its point draws are recomputed from the step's rng (the key its
`train_forward` takes by `make_rng("points")`) and fed into the port.

The batch's base/novel labels are made all novel in view 0 and all base in
view 1, so that loss_3d_contra selects masks and carries gradient. Where
loss_contra fills a selection slot with an empty mask, the JAX package's
gradient of the slot's (zero-weighted) cosine is NaN, from the norm of a
zero vector, and reaches every 3D-UNet leaf; the JAX side here runs with a
cosine loss of the same values whose norm has gradient 0 at zero, as
PyTorch's has, so the rest of the gradient can be compared.

Tolerances: every loss term within 2e-4 (the train golden's), the IoU
histograms exact, the BatchNorm running statistics within 1e-5. Gradients
(read from AdamW's first moment after one step, (1 - b1) * grad on both
sides): each trainable leaf within 1e-2 relative L2 error and 3e-2 of its
largest value. Tighter per-leaf bounds do not hold for the model's own
gradient: it jumps where a sample of the bilinear samplers crosses a pixel
centre or a ReLU input crosses zero, and the two frameworks' fp32 forwards
differ by ~1e-6. Nudging the port's own weights by 1e-6 relative moves its
leaf gradients by several percent of their largest value
(`python -m xmask3d_tpu_torch.tools.grad_sensitivity --device cpu`). So each
leaf is also held to its own sensitivity: its relative L2 gap to JAX may
be at most 8 times the largest relative L2 change that two 1e-6 relative
nudges of the weights make to the port's gradient of that leaf (floored at
1e-4, fp32 rounding between two frameworks' summation orders); a smooth
leaf, whose spread is small, is held far tighter than 1e-2 there. Each
kernel's VJP is held to 1e-4 on its own in `test_torch_autograd.py`. The
image is 128x128, as in `test_torch_model.py`. The trainer's CLI cases run
on the port alone.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_scannet import build_mini_scannet
from test_torch_model import random_variables, to_port_batch
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.losses import criterion as jax_criterion
from xmask3d_tpu.engine.builder import data_tokenizer, model_config_from_cfg, zero_statics
from xmask3d_tpu.engine.train_step import TrainState as JaxTrainState
from xmask3d_tpu.engine.train_step import make_optimizer as jax_make_optimizer
from xmask3d_tpu.engine.train_step import make_train_step as jax_make_train_step
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu_torch.checkpoint.from_jax import _rule, load_jax_variables
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.engine import train as trainer
from xmask3d_tpu_torch.engine.builder import build_train_model
from xmask3d_tpu_torch.engine.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
    weight_losses,
)
from xmask3d_tpu_torch.models.minkunet import _VARIANTS
from xmask3d_tpu_torch.ops.sparse_conv import sparse_conv

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
REDUCED = {"arch_3d": "MinkUNet14A", "arch_binary_head": "MinkUNet14A", "mask_shape": [24, 32],
           "compute_dtype": "float32", "max_points": 512, "max_voxels": 256, "max_targets": 8,
           "dec_layers": 2, "pixel_enc_layers": 2}
IMAGE = 128
TOTAL_STEPS = 100
LOSS_TOL = 2e-4
GRAD_L2_TOL = 1e-2
GRAD_MAX_TOL = 3e-2
GRAD_ZERO_TOL = 1e-6
# the per-leaf check against the model's own sensitivity
NUDGE = 1e-6
NUDGE_SEEDS = (7, 8)
SPREAD_MULTIPLE = 8.0
SPREAD_FLOOR = 1e-4
STATS_TOL = 1e-5


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        elif hasattr(v, "shape"):  # not a masked-out leaf of another group
            out[path] = np.asarray(v)
    return out


def jax_draws(model, variables, points_rng, b, t, num_points, n_layers):
    """The step's point coordinates as the JAX train_forward draws them:
    split(make_rng("points"), 2L), matcher draws from the even keys, the
    mask loss's oversampled / refill draws from a split of the odd ones."""
    key = model.apply(variables, rngs={"points": points_rng}, method=lambda m: m.make_rng("points"))
    keys = jax.random.split(key, 2 * n_layers)
    n_sampled, n_rand = int(num_points * 3.0), num_points - int(0.75 * num_points)
    matcher, over, refill = [], [], []
    for ka, kb in zip(keys[0::2], keys[1::2]):
        matcher.append(jax.random.uniform(ka, (b, num_points, 2)))
        k1, k2 = jax.random.split(kb)
        over.append(jax.random.uniform(k1, (b * t, n_sampled, 2)))
        refill.append(jax.random.uniform(k2, (b * t, n_rand, 2)))
    return {k: torch.from_numpy(np.asarray(jnp.stack(v)))
            for k, v in (("matcher", matcher), ("over", over), ("refill", refill))}


def zero_safe_cosine_loss(a, b, eps=1e-8):
    """The JAX package's `cosine_loss` with the same values, but the norm's
    gradient at a zero vector taken as 0 (PyTorch's convention) instead of
    NaN; see `test_torch_train_losses.py::test_loss_contra_gradient_at_an_empty_mask`."""
    def unit(x):
        s = jnp.sum(x * x, axis=-1, keepdims=True)
        return x / (jnp.where(s > 0, jnp.sqrt(jnp.where(s > 0, s, 1.0)), 0.0) + eps)

    return 1.0 - (unit(a) * unit(b)).sum(-1)


def synthetic_train_batch(seed=0):
    """The step's batch of two 128x128 views. Synthetic base/novel labels
    are drawn per point, so no mask would be novel- or base-dominant and
    loss_3d_contra would be 0: view 0 is made all novel and view 1 all base,
    so the term and its gradient are live."""
    caps = JaxCapacities(max_points=512, max_voxels=256, max_targets=8)
    batch_np = jax_synthetic_batch(2, caps, seed=seed, num_points=400, image_size=(IMAGE, IMAGE),
                                   mask_shape=(24, 32), context_length=16, vocab_size=512)
    batch_np["binary_label_3d"][0] = 0.0
    batch_np["binary_label_3d"][1] = 1.0
    return batch_np


def jax_and_port_step(batch_np):
    """One training step of the JAX package's `make_train_step` (jitted) and
    of the port's, from the same weights, statics and point draws, on
    `batch_np` (numpy, the JAX layout)."""
    jcfg = _cfg(jax_load_config)
    batch = jax.tree_util.tree_map(jnp.asarray, batch_np)
    mc = model_config_from_cfg(jcfg, tiny=True)
    model = JaxXMask3D(cfg=mc)
    rngs = {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(partial(model.init, train=True), rngs, batch, zero_statics(model, jcfg))
    variables = random_variables({"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    tok = data_tokenizer(jcfg, tiny=True)
    text = jax.jit(lambda v, t: model.apply(v, t, method=lambda m, x: m.embed_captions(x)))(
        variables, jnp.asarray(tok(list(jcfg.label))))
    statics = {"text_embed_train": text, "uncond_tokens": jnp.asarray(tok([""]))}

    optimizer = jax_make_optimizer(jcfg.lr_3d, jcfg.lr_others, TOTAL_STEPS)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(params=params, batch_stats=variables["batch_stats"],
                          opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(5))
    step = jax.jit(jax_make_train_step(model, optimizer, dict(jcfg.loss_weight)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_criterion, "cosine_loss", zero_safe_cosine_loss)
        new, metrics = jax.device_get(step(state, batch, statics, jnp.asarray(1.0)))
    t = batch_np["target_labels"].shape[1]
    draws = jax_draws(model, variables, jax.random.split(state.rng)[1], 2, t, mc.num_points,
                      mc.dec_layers + 1)
    inner = new.opt_state.inner_states
    mu = {g: _flat(inner[g].inner_state[0].mu) for g in ("3d", "others")}

    pcfg = _cfg(load_config)
    port = build_train_model(pcfg, tiny=True, device="cpu")
    load_jax_variables(port, jax.device_get(variables))
    p_opt = make_optimizer(port, pcfg.lr_3d, pcfg.lr_others, TOTAL_STEPS)
    p_state = create_train_state(port, p_opt)
    p_statics = {k: torch.from_numpy(np.asarray(v)) for k, v in statics.items()}
    before = dict(sparse_conv.backward_calls)
    p_metrics = make_train_step(dict(pcfg.loss_weight))(
        p_state, to_port_batch(batch_np), p_statics, 1.0, draws=draws)
    k1_backward = {k: n - before[k] for k, n in sparse_conv.backward_calls.items()}
    return {"jax": metrics, "port": p_metrics, "mu": mu, "stats": _flat(new.batch_stats),
            "state": p_state, "variables": variables, "batch_np": batch_np,
            "statics": p_statics, "draws": draws, "k1_backward": k1_backward}


@pytest.fixture(scope="module")
def step_pair():
    return jax_and_port_step(synthetic_train_batch())


def test_train_step_losses_match_jax(step_pair):
    want, got = step_pair["jax"], step_pair["port"]
    terms = [k for k in want if k.startswith("loss")]
    assert len(terms) == 3 * 3 + 8, terms  # 3 prediction layers, the total and 7 more terms
    assert set(terms) == {k for k in got if k.startswith("loss")}
    for k in terms:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    assert float(want["loss_3d_contra"]) > 0, "contra term is zero: no gradient through it"
    for k in ("metric_train_inter", "metric_train_union"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_train_step_takes_k1s_gather_backward_on_every_call(step_pair):
    """Every K1 call of the step (the fused k5 stem, then each MinkUNet's
    four down convs and two k3 convs a residual block) carries its map's
    transpose, so its backward is the gather form: none is the plain VJP."""
    mc = step_pair["state"].model.cfg
    calls = 1 + sum(4 + 2 * sum(_VARIANTS[a][1]) for a in (mc.arch_3d, mc.arch_binary_head))
    assert step_pair["k1_backward"] == {"kernel": calls, "plain": 0}


def _leaves(model):
    """(port module, tensor name, tensor, JAX path, transform) of every
    parameter and buffer, through the weight bridge's rule."""
    for mod_name, mod in model.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for name, t in tensors:
            col, leaf, fn = _rule(mod, name)
            path = "/".join(p for p in (mod_name.replace(".", "/"), leaf) if p)
            yield f"{mod_name}.{name}", t, col, path, fn


def test_train_step_gradients_match_jax(step_pair):
    """First moments after one step, leaf by leaf, on every trainable
    parameter of both groups: relative L2 error within GRAD_L2_TOL and
    largest error within GRAD_MAX_TOL of the leaf's largest value. Leaves
    whose gradient is zero in exact arithmetic (the attention key biases:
    softmax cancels a shift of every score of a query) are held to an
    absolute GRAD_ZERO_TOL of the largest gradient of the model."""
    state = step_pair["state"]
    adam = state.optimizer.adamw.state
    groups = {id(p): g for g, pairs in state.optimizer.pairs.items() for p, _ in pairs}
    pairs = []
    for name, t, col, path, fn in _leaves(state.model):
        if col == "params" and id(t) in groups:
            want = step_pair["mu"][groups[id(t)]][path]
            pairs.append((name, groups[id(t)], adam[t]["exp_avg"].numpy(),
                          fn(want) if fn is not None else want))
    top = max(float(np.abs(w).max()) for *_, w in pairs)
    seen = {"3d": 0, "others": 0}
    for name, g, got, want in pairs:
        assert np.isfinite(got).all(), name
        seen[g] += 1
        if name.endswith("k_proj.bias"):
            assert max(np.abs(got).max(), np.abs(want).max()) <= GRAD_ZERO_TOL * top, name
            continue
        l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        worst = float(np.abs(got - want).max() / np.abs(want).max())
        assert l2 <= GRAD_L2_TOL and worst <= GRAD_MAX_TOL, f"{name}: L2 {l2:.3g}, max {worst:.3g}"
    assert seen == {g: len(m) for g, m in step_pair["mu"].items()}, seen


@pytest.fixture(scope="module")
def nudge_spread(step_pair):
    """The port's own gradient, leaf by leaf, at the step's weights and at
    weights nudged by NUDGE relative (every parameter times 1 + NUDGE *
    N(0, 1), a numpy seed), on the same batch, statics and point draws:
    the method of `tools/grad_sensitivity.py`. Returns (base, nudged)."""
    cfg = _cfg(load_config)
    model = build_train_model(cfg, tiny=True, device="cpu")
    load_jax_variables(model, jax.device_get(step_pair["variables"]))
    batch = to_port_batch(step_pair["batch_np"])
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def grads():
        model.zero_grad(set_to_none=True)
        losses, _ = model(batch, step_pair["statics"], train=True, draws=step_pair["draws"])
        c = model.cfg
        weight_losses(losses, dict(cfg.loss_weight), c.class_weight, c.mask_weight,
                      c.dice_weight, contra_on=1.0).backward()
        model.load_state_dict(start)  # the forward moved the BatchNorm statistics
        return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                if p.grad is not None}

    base = grads()
    params = {k: v.clone() for k, v in start.items()}
    nudged = []
    for seed in NUDGE_SEEDS:
        rng = np.random.RandomState(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.requires_grad:
                    p.copy_(params[name] * torch.from_numpy(
                        np.asarray(1 + NUDGE * rng.randn(*p.shape), np.float32)))
            start.update({k: v.clone() for k, v in model.state_dict().items()})
        nudged.append(grads())
    return base, nudged


def test_train_step_gradient_gaps_within_their_nudge_spread(step_pair, nudge_spread):
    """Each trainable leaf's port-vs-JAX gradient gap against that leaf's
    own spread: the relative L2 gap may be at most SPREAD_MULTIPLE times
    the relative L2 change a NUDGE of the weights makes (floored at
    SPREAD_FLOOR, fp32 rounding of the leaf). A leaf whose gradient is smooth
    has a spread near NUDGE, so a fault in it fails here long before the
    GRAD_L2_TOL bound of `test_train_step_gradients_match_jax` would; a leaf
    behind a bilinear sample or a ReLU kink has a wide spread and a gap to
    match. The port's gradient is taken again here (not AdamW's moment) and
    the JAX one is its first moment over (1 - b1)."""
    base, nudged = nudge_spread
    state = step_pair["state"]
    groups = {id(p): g for g, pairs in state.optimizer.pairs.items() for p, _ in pairs}
    b1 = 0.9
    rows = []
    for name, t, col, path, fn in _leaves(state.model):
        if col != "params" or id(t) not in groups or name.endswith("k_proj.bias"):
            continue
        want = step_pair["mu"][groups[id(t)]][path]
        want = (fn(want) if fn is not None else want) / (1 - b1)
        got = base[name]
        norm = float(np.linalg.norm(got))
        gap = float(np.linalg.norm(got - want)) / norm
        spread = max([float(np.linalg.norm(g[name] - got)) / norm for g in nudged]
                     + [SPREAD_FLOOR])
        rows.append((gap / spread, gap, spread, name))
    rows.sort(reverse=True)
    print("worst gap / spread:", rows[:5])
    assert len(rows) > 100
    bad = [r for r in rows if r[0] > SPREAD_MULTIPLE]
    assert not bad, bad[:8]


def test_train_step_running_statistics_match_jax(step_pair):
    n = 0
    for name, t, col, path, fn in _leaves(step_pair["state"].model):
        if col == "batch_stats":
            np.testing.assert_allclose(t.numpy(), step_pair["stats"][path], rtol=0,
                                       atol=STATS_TOL, err_msg=name)
            n += 1
    assert n == len(step_pair["stats"])


def _tiny_argv(tmp_path, *extra):
    over = {**REDUCED, "batch_size": 2, "epochs": 1, "steps_per_epoch": 2, "val_batches": 1,
            "print_freq": 1, "eval_freq": 1, "save_freq": 1}
    over.update(dict(zip(extra[::2], extra[1::2])))
    argv = ["--config", CONFIG, "--synthetic", "--tiny", "--save_path", str(tmp_path)]
    for k, v in over.items():
        argv += [k, json.dumps(v) if isinstance(v, list) else str(v)]
    return argv


def test_trainer_cli_trains_validates_saves_and_resumes(tmp_path):
    first = trainer.main(_tiny_argv(tmp_path), device="cpu")
    assert first["step"] == 2
    assert np.isfinite(first["last_metrics"]["loss_total"])
    assert set(first["val"]) == {f"{m}{t}" for m in ("mIoU_base", "mIoU_novel", "hIoU")
                                 for t in ("", "_2d", "_3d")}
    assert all(np.isfinite(v) for v in first["val"].values())
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert {r["step"] for r in rows if r["tag"] == "train/loss_total"} == {1, 2}
    assert any(r["tag"] == "val/hIoU" for r in rows)
    assert (tmp_path / "model" / "step_2.pt").exists()

    resumed = trainer.main(_tiny_argv(tmp_path, "epochs", 2, "--resume", "1"), device="cpu")
    assert resumed["step"] == 4
    assert resumed["best_iou"] >= first["best_iou"]
    assert (tmp_path / "model" / "step_4.pt").exists()


def test_checkpoint_restores_into_a_built_state(tmp_path):
    """Masters, running statistics, optimizer state and the step come back;
    frozen parameters keep the values of the state restored into."""
    from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer
    from xmask3d_tpu_torch.engine.builder import label_tree

    cfg = _cfg(load_config)
    a = create_train_state(build_train_model(cfg, tiny=True, seed=0, device="cpu"), None)
    a.optimizer = make_optimizer(a.model, 1e-3, 1e-4, 10)
    for p in a.model.parameters():
        p.grad = torch.ones_like(p) if p.requires_grad else None
    a.optimizer.step(0)
    for buf in a.model.buffers():
        buf.add_(0.25)
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(s, a, best_iou=0.5)
    assert ck.steps() == [2, 3]

    b = create_train_state(build_train_model(cfg, tiny=True, seed=1, device="cpu"), None)
    b.optimizer = make_optimizer(b.model, 1e-3, 1e-4, 10)
    frozen_before = {n: p.clone() for n, p in b.model.named_parameters()
                     if label_tree(b.model)[n] == "frozen"}
    b, meta = ck.restore(b)
    assert meta == {"step": 3, "best_iou": 0.5} and b.step == 3
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for n, p in pb.items():
        want = frozen_before[n] if n in frozen_before else pa[n]
        torch.testing.assert_close(p, want, rtol=0, atol=0, msg=n)
    for (n, x), (_, y) in zip(a.model.named_buffers(), b.model.named_buffers()):
        torch.testing.assert_close(y, x, rtol=0, atol=0, msg=n)
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sb[k]["exp_avg"], sa[k]["exp_avg"], rtol=0, atol=0)


def test_trainer_cli_scannet_branch(tmp_path):
    root = build_mini_scannet(tmp_path / "data", n_views=2)
    # one scene with loop 2 is an epoch of one step of two views
    argv = _tiny_argv(tmp_path / "run", "loop", 2, "max_points", 2048,
                      "max_voxels", 2048, "data_root", str(root / "scannet_3d"),
                      "data_root_2d", str(root / "scannet_2d"),
                      "caption_path", str(root / "caption.json"))
    argv.remove("--synthetic")
    with pytest.raises(RuntimeError, match="HashTokenizer"):
        trainer.main(argv, device="cpu")
    out = trainer.main(argv + ["--allow_hash_tokenizer"], device="cpu")
    assert out["step"] == 1
    assert np.isfinite(out["last_metrics"]["loss_total"])
    assert all(np.isfinite(v) for v in out["val"].values())


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.main(_tiny_argv(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_model(_cfg(load_config), tiny=True)


def test_trainer_logs_the_config_keys_it_does_not_honour(tmp_path):
    """B15N4 sets `donate_state`, which the JAX trainer obeys and the
    port's does not: the trainer logs one warning, naming what it does
    instead (no ROADMAP item: its in-place update leaves nothing to port);
    a config without it logs nothing. `mesh_shape` is honoured, its model
    axis too (tensor parallelism), so no mesh is logged; one that the world
    cannot give (a model axis of 2 or a data axis of 4 in a one-process
    world) makes the trainer raise, as the JAX `create_mesh` does.
    `workers` and `remat_backbone`, which the trainer honours, are not
    among them."""
    import logging

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep(level=logging.WARNING)
    trainer.logger.addHandler(handler)
    try:
        trainer.main(_tiny_argv(tmp_path, "steps_per_epoch", 1, "evaluate", False), device="cpu")
        got = [ln for ln in lines if "is not honoured" in ln]
        lines.clear()
        cfg = _cfg(load_config)
        for key in trainer.UNHONOURED_KEYS:
            cfg.pop(key)
        trainer.log_unhonoured_keys(cfg)
        assert not lines
        for mesh in ({"data": -1, "model": 2}, {"data": 4, "model": 1}):
            cfg["mesh_shape"] = mesh
            trainer.log_unhonoured_keys(cfg)
        mesh_lines = list(lines)
    finally:
        trainer.logger.removeHandler(handler)
    assert [ln.split()[2] for ln in got] == ["donate_state"]
    assert "no ROADMAP item" in got[0], got[0]
    assert mesh_lines == []
    for axis, n, why in (("model", 2, "not divisible"), ("data", 4, "!=")):
        with pytest.raises(ValueError, match=why):
            trainer.main(_tiny_argv(tmp_path / "bad", f"mesh_shape.{axis}", n), device="cpu")
    assert _cfg(load_config)["remat_backbone"] is True


# ---------------------------------------------------------------------------
# a JAX run's orbax checkpoint into the port (scripts/orbax_to_torch.py)
# ---------------------------------------------------------------------------

UPDATE_TOL = 1e-6  # fp32, relative to each leaf's largest value


def _orbax_to_torch():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "orbax_to_torch.py")
    spec = importlib.util.spec_from_file_location("orbax_to_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reduced_opts():
    return [str(x) for k, v in REDUCED.items()
            for x in (k, json.dumps(v) if isinstance(v, list) else v)]


def _trainable_and_some_frozen(params, label, keep=(
        "backbone/feature_extractor/ldm_extractor/shared_noise", "clip/logit_scale")):
    """The JAX params tree without the frozen towers' leaves but `keep`: a
    checkpoint holds no frozen leaf, the frozen group's state stays in the
    optimizer (as masked leaves), and the update compiles in a third of the
    time over 440 leaves instead of 1,460."""
    out = {}
    for path, leaf in _flat(params).items():
        if label(path.split("/")) == "frozen" and path not in keep:
            continue
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


@pytest.fixture(scope="module")
def orbax_saved(step_pair, tmp_path_factory):
    """One optax update of the step's JAX weights (the trainable ones and
    two frozen leaves) on seeded random gradients (no forward; the update
    jitted), saved by the JAX package's orbax Checkpointer at step 1 with
    perturbed BatchNorm statistics; and the next update on the same
    gradients."""
    import optax
    from xmask3d_tpu.checkpoint.orbax_io import Checkpointer as OrbaxCheckpointer

    from xmask3d_tpu.engine.train_step import param_label

    jcfg = _cfg(jax_load_config)
    opt = jax_make_optimizer(jcfg.lr_3d, jcfg.lr_others, TOTAL_STEPS)
    rng = np.random.RandomState(3)
    params = _trainable_and_some_frozen(step_pair["variables"]["params"], param_label)
    grads = jax.tree_util.tree_map(lambda p: np.asarray(rng.randn(*np.shape(p)), np.float32),
                                   params)
    stats = jax.tree_util.tree_map(
        lambda s: np.asarray(np.abs(np.asarray(s) + rng.randn(*np.shape(s))), np.float32),
        step_pair["variables"]["batch_stats"])

    @jax.jit
    def update(params, opt_state):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = update(params, jax.jit(opt.init)(params))
    root = tmp_path_factory.mktemp("orbax")
    state = JaxTrainState(params=params, batch_stats=stats, opt_state=opt_state,
                          step=jnp.ones((), jnp.int32), rng=jax.random.PRNGKey(5))
    OrbaxCheckpointer(str(root / "jax" / "model")).save(1, state, best_iou=0.25)
    return {"root": root, "params": _flat(jax.device_get(params)), "grads": _flat(grads),
            "stats": _flat(stats), "inner": jax.device_get(opt_state.inner_states),
            "next": _flat(jax.device_get(update(params, opt_state)[0]))}


@pytest.fixture(scope="module")
def orbax_run(orbax_saved):
    """`orbax_saved` converted by `scripts/orbax_to_torch.py` into a port
    checkpoint directory."""
    root = orbax_saved["root"]
    written, tree = _orbax_to_torch().convert(
        str(root / "jax" / "model"), str(root / "port" / "model"), CONFIG, _reduced_opts(),
        tiny=True)
    return {**orbax_saved, "written": written, "tree": tree}


def test_orbax_checkpoint_reads_without_a_template(orbax_run):
    """The reader sees optax's states as orbax gives them without a
    template: each group's adamw chain as a list whose first state holds
    the count and the moments, the other group's leaves masked (None)."""
    tree = orbax_run["tree"]
    assert tree["meta"] == {"step": 1, "best_iou": 0.25}
    assert set(tree["trainable"]) == {p for g in ("3d", "others")
                                      for p in _flat(orbax_run["inner"][g].inner_state[0].mu)}
    for g in ("3d", "others"):
        adam = tree["opt_state"]["inner_states"][g]["inner_state"][0]
        assert int(adam["count"]) == 1
        masked = adam["mu"]["pc_decoder"]["MinkUNet_0"]["conv0"]["kernel"] is None
        assert masked == (g == "others"), g
        assert adam["mu"]["clip"]["logit_scale"] is None  # the frozen group's
    assert tree["opt_state"]["inner_states"]["frozen"]["inner_state"] is None


def _port_layout(fn, a):
    return np.asarray(fn(a) if fn is not None else a)


def test_orbax_checkpoint_restores_into_the_port_and_updates_as_optax(orbax_run):
    """Every leaf of the converted checkpoint equals the JAX one after the
    weight bridge's relayout: trainable masters, BatchNorm statistics,
    AdamW's moments and counts (as `Checkpointer.restore` loads them into a
    built state, and `restore_for_serving` into a serving model); then one
    more update on the same gradients moves the masters as optax moves the
    JAX parameters, within UPDATE_TOL of each leaf's largest value."""
    from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer
    from xmask3d_tpu_torch.engine.builder import build_model, label_tree

    assert orbax_run["written"].endswith("step_1.pt")
    cfg = _cfg(load_config)
    model = build_train_model(cfg, tiny=True, seed=1, device="cpu")
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others,
                                                     TOTAL_STEPS))
    state, meta = Checkpointer(str(orbax_run["root"] / "port" / "model")).restore(state)
    assert meta == {"step": 1, "best_iou": 0.25} and state.step == 1
    adam = state.optimizer.adamw.state
    labels = label_tree(state.model)
    inner = orbax_run["inner"]
    mu = {g: _flat(inner[g].inner_state[0].mu) for g in ("3d", "others")}
    nu = {g: _flat(inner[g].inner_state[0].nu) for g in ("3d", "others")}
    count = {g: int(inner[g].inner_state[0].count) for g in ("3d", "others")}
    n = {"params": 0, "batch_stats": 0}
    for name, t, col, path, fn in _leaves(state.model):
        if col == "batch_stats":
            np.testing.assert_array_equal(t.numpy(), orbax_run["stats"][path], err_msg=name)
            n[col] += 1
        elif labels[name] != "frozen":
            g = labels[name]
            np.testing.assert_array_equal(
                t.detach().numpy(), _port_layout(fn, orbax_run["params"][path]), err_msg=name)
            np.testing.assert_array_equal(adam[t]["exp_avg"].numpy(),
                                          _port_layout(fn, mu[g][path]), err_msg=name)
            np.testing.assert_array_equal(adam[t]["exp_avg_sq"].numpy(),
                                          _port_layout(fn, nu[g][path]), err_msg=name)
            assert int(adam[t]["step"]) == count[g] == 1, name
            n[col] += 1
    assert n["params"] == sum(len(m) for m in mu.values()) and n["batch_stats"] == len(
        orbax_run["stats"])

    serving = build_model(cfg, tiny=True, seed=2, device="cpu")
    Checkpointer(str(orbax_run["root"] / "port" / "model")).restore_for_serving(serving)
    for name, t, col, path, fn in _leaves(serving):
        want = orbax_run["stats"] if col == "batch_stats" else orbax_run["params"]
        if col == "batch_stats" or labels[name] != "frozen":
            np.testing.assert_array_equal(t.numpy(), _port_layout(fn, want[path]), err_msg=name)

    with torch.no_grad():
        for name, t, col, path, fn in _leaves(state.model):
            if col == "params" and labels[name] != "frozen":
                t.grad = torch.from_numpy(_port_layout(fn, orbax_run["grads"][path]).copy())
    state.optimizer.step(state.step)
    for name, t, col, path, fn in _leaves(state.model):
        if col == "params" and labels[name] != "frozen":
            want = _port_layout(fn, orbax_run["next"][path])
            err = float(np.abs(t.detach().numpy() - want).max())
            assert err <= UPDATE_TOL * max(float(np.abs(want).max()), 1e-30), (name, err)


def test_an_orbax_directory_given_to_the_port_names_the_converter(orbax_run):
    from xmask3d_tpu_torch.engine.infer_cli import build_serving_model

    with pytest.raises(FileNotFoundError, match="orbax_to_torch"):
        build_serving_model(_cfg(load_config), tiny=True, device="cpu",
                            ckpt=str(orbax_run["root"] / "jax" / "model"))
