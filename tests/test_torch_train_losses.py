"""The port's training pieces against the JAX package, one by one: point
sampling and the pairwise costs, the Hungarian matcher and its solver, every
criterion term (values and gradients), the IoU histograms, the loss
weighting and its contra gate, the learning-rate schedules, the two-group
AdamW against optax, and the parameter groups.

Random coordinates are drawn by JAX from its keys, exactly as its functions
draw them, and handed to the port. Tolerances: 2e-4 on loss terms (the train
golden's), 1e-4 of the largest value on gradients and sampled values, exact
on assignments and histograms, 1e-6 on optimizer updates.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.engine import train_step as jts
from xmask3d_tpu.engine.builder import model_config_from_cfg, zero_statics
from xmask3d_tpu.losses import criterion as jc
from xmask3d_tpu.losses.focal import focal_loss as jax_focal_loss
from xmask3d_tpu.losses.matcher import hungarian_match as jax_hungarian_match
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu.ops import point_sample as jps
from xmask3d_tpu.ops.hungarian import linear_sum_assignment as jax_lsa
from xmask3d_tpu.utils import lr_schedule as jlr
from xmask3d_tpu.utils.metrics import intersection_and_union as jax_iou
from xmask3d_tpu_torch.checkpoint.from_jax import _rule
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.engine.builder import build_train_model, label_tree
from xmask3d_tpu_torch.engine.train_step import make_optimizer, weight_losses
from xmask3d_tpu_torch.losses import criterion as tc
from xmask3d_tpu_torch.losses.focal import focal_loss
from xmask3d_tpu_torch.losses.matcher import hungarian_match
from xmask3d_tpu_torch.ops import point_sample as tps
from xmask3d_tpu_torch.ops.hungarian import linear_sum_assignment
from xmask3d_tpu_torch.utils import lr_schedule as tlr
from xmask3d_tpu_torch.utils.metrics import intersection_and_union

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
LOSS_TOL = 2e-4
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(scale, 1.0), f"{what}: {err:.3g} > {tol} x {scale:.3g}"


def _masks(seed, b=2, q=7, h=12, w=10, t_=5):
    rng = np.random.RandomState(seed)
    pred = (2 * rng.randn(b, q, h, w)).astype(np.float32)
    labels2d = rng.randint(0, 4, size=(b, 2 * h, 2 * w))
    tl = np.full((b, t_), -1, np.int32)
    tl[:, :3] = [[0, 1, 3], [1, 2, 3]]
    tv = tl >= 0
    tm = ((labels2d[:, None] == tl[:, :, None, None]) * tv[:, :, None, None]).astype(np.float32)
    logits = rng.randn(b, q, 5).astype(np.float32)
    return pred, tm, tl, tv, logits


def test_point_sample_matches_jax():
    rng = np.random.RandomState(0)
    masks = rng.randn(2, 3, 9, 11).astype(np.float32)
    coords = rng.uniform(-0.05, 1.05, size=(2, 50, 2)).astype(np.float32)
    _close(tps.point_sample(t(masks), t(coords)),
           jps.point_sample(jnp.asarray(masks), jnp.asarray(coords)), what="point_sample")


def test_uncertainty_sampling_with_jax_draws():
    """JAX's draws from its two keys, fed to the port: the same points."""
    pred, *_ = _masks(1)
    mp = jnp.asarray(pred[:, :1])
    key = jax.random.PRNGKey(3)
    n, ratio = 40, 0.75
    want = jps.uncertainty_sampled_points(key, mp, n, 3.0, ratio)
    k1, k2 = jax.random.split(key)
    over = jax.random.uniform(k1, (2, 120, 2))
    refill = jax.random.uniform(k2, (2, n - int(ratio * n), 2))
    got = tps.uncertainty_sampled_points(t(pred[:, :1]), t(over), t(refill), n, ratio)
    # the kept points are a set (top-k order may differ between frameworks)
    g, w = got.numpy(), np.asarray(want)
    for i in range(2):
        kept = int(ratio * n)
        assert sorted(map(tuple, g[i, :kept])) == sorted(map(tuple, w[i, :kept]))
        np.testing.assert_array_equal(g[i, kept:], w[i, kept:])


def test_point_draws_shapes_and_range():
    gen = torch.Generator().manual_seed(0)
    d = tps.point_draws(gen, 3, 2, 5, 40)
    assert d["matcher"].shape == (3, 2, 40, 2)
    assert d["over"].shape == (3, 10, 120, 2) and d["refill"].shape == (3, 10, 10, 2)
    assert all(float(v.min()) >= 0 and float(v.max()) < 1 for v in d.values())


def test_pairwise_costs_match_jax():
    rng = np.random.RandomState(2)
    x = (3 * rng.randn(6, 30)).astype(np.float32)
    y = (rng.rand(4, 30) > 0.5).astype(np.float32)
    _close(tps.dice_loss_pairwise(t(x), t(y)), jps.dice_loss_pairwise(x, y), what="dice")
    _close(tps.sigmoid_ce_pairwise(t(x), t(y)), jps.sigmoid_ce_pairwise(x, y), what="ce")
    _close(tps.dice_loss(t(x[:4]), t(y)), jps.dice_loss(x[:4], y), what="dice")
    _close(tps.sigmoid_ce_loss(t(x[:4]), t(y)), jps.sigmoid_ce_loss(x[:4], y), what="ce")


def test_hungarian_match_with_jax_draws():
    pred, tm, tl, tv, logits = _masks(3)
    key = jax.random.PRNGKey(11)
    n = 64
    want = np.asarray(jax_hungarian_match(key, jnp.asarray(logits), jnp.asarray(pred),
                                          jnp.asarray(tl), jnp.asarray(tm), jnp.asarray(tv),
                                          num_points=n))
    coords = jax.random.uniform(key, (2, n, 2))
    got = hungarian_match(t(logits), t(pred), t(tl), t(tm), t(tv), t(coords)).numpy()
    np.testing.assert_array_equal(got[tv], want[tv])


@pytest.mark.parametrize("case", ["random", "ties", "nonfinite"])
def test_linear_sum_assignment_against_jax_and_scipy(case):
    """Optimal total cost equal to scipy's and to the JAX solver's; on ties
    the assignment may differ but its cost may not; NaN and +-inf costs are
    made large finite ones before solving, as the JAX package does."""
    rng = np.random.RandomState(5)
    cost = rng.rand(3, 6, 11).astype(np.float32)
    if case == "ties":
        cost = np.round(cost * 3) / 3
        cost[:, 4:] = 0.0  # uniform padded rows
    if case == "nonfinite":
        cost[0, 1, 2] = np.nan
        cost[1, 0, :] = np.inf
        cost[2, 3, 5] = -np.inf
        cost[2, 2, :4] = np.nan
    got = linear_sum_assignment(t(cost)).numpy()
    safe = np.nan_to_num(cost, nan=1e9, posinf=1e9, neginf=-1e9)
    for i in range(3):
        assert len(set(got[i])) == 6
        want_jax = np.asarray(jax_lsa(jnp.asarray(cost[i])))
        r, c = scipy_lsa(safe[i])
        rows = np.arange(6)
        best = safe[i][r, c].sum()
        assert safe[i][rows, got[i]].sum() == pytest.approx(best, rel=1e-6)
        assert safe[i][rows, want_jax].sum() == pytest.approx(best, rel=1e-6)
        if case == "random":
            np.testing.assert_array_equal(got[i], want_jax)


def _jax_port_grad(jfn, tfn, arrays, argnums):
    """(JAX value, port value, JAX grads, port grads) of scalar functions."""
    want, jg = jax.value_and_grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    xs = [t(a) for a in arrays]
    for i in argnums:
        xs[i].requires_grad_()
    got = tfn(*xs)
    got.backward()
    return want, got, list(jg), [torch.zeros_like(xs[i]) if xs[i].grad is None else xs[i].grad
                                 for i in argnums]


def test_loss_labels_and_masks_match_jax():
    pred, tm, tl, tv, logits = _masks(6)
    match = np.array([[0, 3, 5, 1, 2], [6, 4, 0, 2, 1]], np.int32)
    w, g, jg, tg = _jax_port_grad(
        lambda lg: jc.loss_labels(lg, jnp.asarray(tl), jnp.asarray(tv), jnp.asarray(match)),
        lambda lg: tc.loss_labels(lg, t(tl), t(tv), t(match)), [logits], (0,))
    _close(g, w, LOSS_TOL, "loss_labels")
    _close(tg[0], jg[0], TOL, "loss_labels grad")

    key = jax.random.PRNGKey(9)
    n = 48
    k1, k2 = jax.random.split(key)
    over = t(jax.random.uniform(k1, (10, 144, 2)))
    refill = t(jax.random.uniform(k2, (10, n - int(0.75 * n), 2)))
    nm = jnp.asarray(3.0)
    for i, name in enumerate(("loss_mask", "loss_dice")):
        w, g, jg, tg = _jax_port_grad(
            lambda p: jc.loss_masks(key, p, jnp.asarray(tm), jnp.asarray(tv), jnp.asarray(match),
                                    nm, num_points=n)[i],
            lambda p: tc.loss_masks(p, t(tm), t(tv), t(match), torch.tensor(3.0), over, refill,
                                    num_points=n)[i], [pred], (0,))
        _close(g, w, LOSS_TOL, name)
        _close(tg[0], jg[0], TOL, name + " grad")


def test_loss_exact_and_caption_and_binary_match_jax():
    rng = np.random.RandomState(7)
    fused = rng.randn(2, 40, 16).astype(np.float32)
    pure = rng.randn(2, 40, 16).astype(np.float32)
    text = rng.randn(5, 16).astype(np.float32)
    null = rng.randn(1, 16).astype(np.float32)
    labels = rng.randint(0, 7, size=(2, 40)).astype(np.int32)
    pv = rng.rand(2, 40) > 0.2
    for key in ("loss_3d", "loss_3d_pure"):
        w, g, jg, tg = _jax_port_grad(
            lambda f, p: jc.loss_exact(f, p, jnp.asarray(text), jnp.asarray(null), 14.0,
                                       jnp.asarray(labels), jnp.asarray(pv), 5)[key],
            lambda f, p: tc.loss_exact(f, p, t(text), t(null), 14.0, t(labels), t(pv), 5)[key],
            [fused, pure], (0, 1))
        _close(g, w, LOSS_TOL, key)
        for a, b in zip(tg, jg):
            _close(a, b, TOL, key + " grad")
    cap = rng.randn(2, 16).astype(np.float32)
    w, g, jg, tg = _jax_port_grad(
        lambda f: jc.caption_cosine_loss(f, jnp.asarray(pv), jnp.asarray(cap)),
        lambda f: tc.caption_cosine_loss(f, t(pv), t(cap)), [fused], (0,))
    _close(g, w, LOSS_TOL, "caption")
    _close(tg[0], jg[0], TOL, "caption grad")
    scores = (2 * rng.randn(2, 40)).astype(np.float32)
    blabels = rng.choice([0.0, 1.0, 19.0, 20.0], size=(2, 40)).astype(np.float32)
    w, g, jg, tg = _jax_port_grad(
        lambda s: jc.binary_bce_loss(s, jnp.asarray(blabels), jnp.asarray(pv), (19, 20), 0.267),
        lambda s: tc.binary_bce_loss(s, t(blabels), t(pv), (19, 20), 0.267), [scores], (0,))
    _close(g, w, LOSS_TOL, "binary")
    _close(tg[0], jg[0], TOL, "binary grad")


def _contra_case(seed):
    rng = np.random.RandomState(seed)
    b, q, p = 2, 9, 400
    mask_3d = rng.rand(b, q, p) > 0.6
    mask_3d[:, 7:] = False  # empty masks
    logits = (2 * rng.randn(b, q, 12, 16)).astype(np.float32)
    clip = rng.randn(b, q, 16).astype(np.float32)
    f3d = rng.randn(b, p, 16).astype(np.float32)
    binary = np.zeros((b, p), np.float32)
    binary[1] = 1.0  # view 0 all novel, view 1 all base
    pv = rng.rand(b, p) > 0.1
    return mask_3d, logits, clip, f3d, binary, pv


def test_loss_contra_matches_jax():
    mask_3d, logits, clip, f3d, binary, pv = _contra_case(8)
    # every slot filled by a flagged, non-empty mask: the JAX gradient is finite
    mask_3d[1, :7] = True
    w, g, jg, tg = _jax_port_grad(
        lambda f: jc.loss_contra(jnp.asarray(mask_3d), jnp.asarray(logits), jnp.asarray(clip), f,
                                 jnp.asarray(binary), jnp.asarray(pv)),
        lambda f: tc.loss_contra(t(mask_3d), t(logits), t(clip), f, t(binary), t(pv)),
        [f3d], (0,))
    assert float(w) > 0
    _close(g, w, LOSS_TOL, "loss_contra")
    _close(tg[0], jg[0], TOL, "loss_contra grad")
    none = np.zeros_like(mask_3d)
    assert float(tc.loss_contra(t(none), t(logits), t(clip), t(f3d), t(binary * 0 + 0.5),
                                t(pv))) == 0.0


def test_loss_contra_gradient_at_an_empty_mask():
    """A fault of the JAX package, kept out of the port: where fewer masks
    are flagged than loss_contra has slots, a slot can take an empty mask,
    whose mean 3D feature is the zero vector; the slot is weighted 0, but
    the gradient of the norm at zero is NaN in JAX and NaN * 0 is NaN, so
    every 3D feature's gradient is NaN. PyTorch's norm has gradient 0 at
    zero, so the port's gradient is finite and equals JAX's on the other
    slots."""
    mask_3d, logits, clip, f3d, binary, pv = _contra_case(9)
    # view 1 (all base) flags no mask, so its slot takes the first query,
    # made empty here
    mask_3d[1, 0] = False
    jg = jax.grad(lambda f: jc.loss_contra(jnp.asarray(mask_3d), jnp.asarray(logits),
                                           jnp.asarray(clip), f, jnp.asarray(binary),
                                           jnp.asarray(pv)))(jnp.asarray(f3d))
    assert np.isnan(np.asarray(jg)).any()
    x = t(f3d).requires_grad_()
    loss = tc.loss_contra(t(mask_3d), t(logits), t(clip), x, t(binary), t(pv))
    loss.backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0


def test_focal_and_masked_ce_match_jax():
    rng = np.random.RandomState(10)
    logits = rng.randn(3, 20, 6).astype(np.float32)
    labels = rng.choice([0, 1, 2, 5, 255], size=(3, 20)).astype(np.int32)
    _close(focal_loss(t(logits), t(labels)), jax_focal_loss(jnp.asarray(logits),
                                                            jnp.asarray(labels)), LOSS_TOL)
    valid = rng.rand(3, 20) > 0.3
    _close(tc.masked_cross_entropy(t(logits), t(labels), t(valid), 255),
           jc.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(valid), 255), LOSS_TOL)


def test_intersection_and_union_matches_jax():
    rng = np.random.RandomState(11)
    pred = rng.randint(0, 17, size=(2, 300))  # 15 and 16 lie outside the 15 bins
    target = rng.randint(0, 16, size=(2, 300))
    valid = rng.rand(2, 300) > 0.2
    got = intersection_and_union(t(pred), t(target), 15, ignore_index=(15,), valid=t(valid))
    want = jax_iou(jnp.asarray(pred), jnp.asarray(target), 15, ignore_index=(15,),
                   valid=jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_weight_losses_and_contra_gate():
    rng = np.random.RandomState(12)
    keys = ["loss_ce", "loss_mask", "loss_dice", "loss_ce_0", "loss_mask_0", "loss_dice_0",
            "loss_3d", "loss_3d_pure", "loss_3d_contra", "loss_explicit_contra",
            "loss_explicit_contra_3d", "loss_explicit_contra_2d_pre", "loss_binary"]
    losses = {k: float(rng.rand()) for k in keys}
    losses["metric_train_inter"] = np.ones(15, np.float32)
    lw = dict(jax_load_config(CONFIG).loss_weight)
    for gate in (0.0, 1.0, None):
        want = jts.weight_losses({k: jnp.asarray(v) for k, v in losses.items()}, lw,
                                 contra_on=None if gate is None else jnp.asarray(gate))
        got = weight_losses({k: torch.tensor(v) for k, v in losses.items()}, lw, contra_on=gate)
        _close(got, want, 1e-6, f"gate {gate}")
    off = weight_losses({k: torch.tensor(v) for k, v in losses.items()}, lw, contra_on=0.0)
    on = weight_losses({k: torch.tensor(v) for k, v in losses.items()}, lw, contra_on=1.0)
    assert float(on - off) == pytest.approx(lw["loss_3d_contra"] * losses["loss_3d_contra"],
                                            rel=1e-5)


@pytest.mark.parametrize("step", [0, 1, 37, 99])
def test_lr_schedules_match_jax(step):
    # JAX evaluates in fp32: within 1e-6 of the base rate
    assert tlr.cosine_lr(1e-3, step, 100) == pytest.approx(float(jlr.cosine_lr(1e-3, step, 100)),
                                                           rel=0, abs=1e-9)
    assert tlr.poly_lr(1e-3, step, 100, 0.9) == pytest.approx(
        float(jlr.poly_lr(1e-3, step, 100, 0.9)), rel=0, abs=1e-9)


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny model of both packages: the port's module and the JAX
    parameter tree's shapes."""
    jcfg = jax_load_config(CONFIG)
    jcfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
                compute_dtype="float32")
    batch = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(
        1, JaxCapacities(64, 32, 4), seed=0, num_points=60, image_size=(64, 64),
        mask_shape=(24, 32), context_length=16, vocab_size=512))
    model = JaxXMask3D(cfg=model_config_from_cfg(jcfg, tiny=True))
    shapes = jax.eval_shape(partial(model.init, train=True),
                            {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)},
                            batch, zero_statics(model, jcfg))
    cfg = load_config(CONFIG)
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32")
    return build_train_model(cfg, tiny=True, device="cpu"), shapes["params"]


def test_param_label_matches_jax_on_every_leaf(tiny_models):
    port, params = tiny_models
    jax_labels = {"/".join(str(getattr(k, "key", k)) for k in path): lab
                  for path, lab in jax.tree_util.tree_flatten_with_path(
                      jts.label_tree(params))[0]}
    labels = label_tree(port)
    n = 0
    for mod_name, mod in port.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            _, leaf, _ = _rule(mod, name)
            path = "/".join(x for x in (mod_name.replace(".", "/"), leaf) if x)
            full = f"{mod_name}.{name}" if mod_name else name
            assert labels[full] == jax_labels[path], (full, path)
            assert p.requires_grad == (labels[full] != "frozen"), full
            n += 1
    assert n == len(jax_labels)
    assert {"3d", "others", "frozen"} == set(labels.values())


def test_optimizer_matches_optax(tiny_models):
    """Three steps of both groups on the same fp32 gradients: AdamW (b1 0.9,
    b2 0.999, eps 1e-8, decay 0.01) at each group's cosine learning rate of
    the step before the update."""
    port, _ = tiny_models
    labels = label_tree(port)
    names = [n for n, _ in port.named_parameters() if labels[n] != "frozen"]
    names = [n for n in names if labels[n] == "3d"][:6] + \
        [n for n in names if labels[n] == "others"][:6]
    params = dict(port.named_parameters())
    start = {n: params[n].detach().numpy().copy() for n in names}
    opt = make_optimizer(port, 1e-3, 1e-4, 10)
    tx = optax.multi_transform(
        {g: optax.adamw(learning_rate=lambda s, b=base: jlr.cosine_lr(b, s, 10), b1=0.9,
                        b2=0.999, eps=1e-8, weight_decay=0.01)
         for g, base in (("3d", 1e-3), ("others", 1e-4))},
        {n: labels[n] for n in names})
    jparams = {n: jnp.asarray(start[n]) for n in names}
    state = tx.init(jparams)
    rng = np.random.RandomState(13)
    for step in range(3):
        grads = {n: rng.randn(*start[n].shape).astype(np.float32) for n in names}
        for n, p in port.named_parameters():
            if p.requires_grad:
                p.grad = t(grads[n]) if n in grads else torch.zeros_like(p)
        opt.step(step)
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for n in names:
        np.testing.assert_allclose(params[n].detach().numpy(), np.asarray(jparams[n]),
                                   rtol=0, atol=1e-6, err_msg=n)
        assert params[n].grad is None
