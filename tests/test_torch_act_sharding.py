"""Activation sharding (`xmask3d_tpu_torch/parallel/spatial.py`) on the CPU:
the counterpart of `tests/test_act_sharding.py` at its sizes.

Two gloo ranks on a (1, 2) mesh are spawned once for the module
(`tests/torch_dist_worker.py` job `act_shard`) and run every case; the
references are this process's (no process group) and the JAX package's
replicated forwards, which `tests/test_act_sharding.py` holds equal to its
sharded ones (no JAX model is compiled under a mesh here).

- `UNET_TINY` at a 32^2 latent: eps and the four taps in bands equal one
  process within atol 1e-4 in fp32 and JAX within rtol = atol = 2e-3 (as
  `tests/test_torch_diffusion.py` holds the port).
- At 16^2, a sum-of-squares loss: the gradients of every parameter (the
  bands' shares summed by `reduce_band_grads`), of `context` and of
  `cond_emb` within a relative 0.02 of max(|r|, 1) of one process (JAX's
  rule), with remat off and on, and with `shard_params` as well (sequence
  parallelism), the latter equal bit for bit when the reduce-scatter and
  the all-to-all take the all-reduce and all-gather forms that gloo runs
  on CUDA tensors.
- `VAE_TINY` encode at 64^2, plain and with `fused_gn` (K4's plain band
  version), within 1e-4 of one process and 2e-3 of JAX; the fused encode's
  parameter gradients by the rule above.
- What runs replicated is one process's bit for bit: a 7-row latent
  through the decoder, an 8^2 latent through the UNet (its last level
  would not split), `shard_spatial` of 7 rows, and sharding off.
- The tiny train step on a model axis of 2 with `shard_params` and bands
  against one process's, with `tests/test_torch_tensor_parallel.py`'s
  tolerances.
- Single-process checks of the pieces: the band check, the no-ops, and
  K4's band contract on the plain versions (moments of row bands merged
  in rank order give the whole map's affine; the conv of a band with raw
  halo rows gives the whole conv's rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import random_variables
from test_torch_train import GRAD_L2_TOL, GRAD_MAX_TOL, LOSS_TOL, REDUCED, STATS_TOL
from torch_dist_worker import _tiny_cfg, _unet_loss, spawn_ranks
from xmask3d_tpu.models.sd_unet import SDUNet as JUNet
from xmask3d_tpu.models.vae import AutoencoderKL as JVAE
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model
from xmask3d_tpu_torch.engine.train_step import create_train_state, make_optimizer, make_train_step
from xmask3d_tpu_torch.models.layers import set_remat
from xmask3d_tpu_torch.models.sd_unet import SDUNet, UNET_TINY
from xmask3d_tpu_torch.models.vae import AutoencoderKL, VAE_TINY
from xmask3d_tpu_torch.ops import gn_conv
from xmask3d_tpu_torch.ops.point_sample import point_draws
from xmask3d_tpu_torch.parallel import spatial
from xmask3d_tpu_torch.parallel.mesh import Mesh

BAND_ATOL = 1e-4     # bands against one process, fp32 (tests/test_act_sharding.py)
JAX_TOL = 2e-3       # against the JAX package's forward (tests/test_torch_diffusion.py)
GRAD_REL = 0.02      # |g - r| / max(|r|, 1) (tests/test_act_sharding.py)
NORM_RTOL = 1e-4     # the gradient norms (tests/test_torch_tensor_parallel.py)
TOTAL_STEPS = 100


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(unet, x, t, ctx, cond):
    unet.zero_grad(set_to_none=True)
    ctx, cond = ctx.clone().requires_grad_(), cond.clone().requires_grad_()
    _unet_loss(unet(x, t, ctx, cond, full=True)).backward()
    return {"params": {n: p.grad.clone() for n, p in unet.named_parameters()},
            "context": ctx.grad, "cond_emb": cond.grad}


def _train_inputs():
    """The tiny train model's start state, a batch of two 128^2 views (view
    0 all novel, view 1 all base, unequal valid points), statics and point
    draws, and one process's step from them."""
    cfg = _tiny_cfg(REDUCED)
    caps = Capacities(max_points=512, max_voxels=256, max_targets=8)
    batch = synthetic_batch(2, caps, seed=0, num_points=400, image_size=(128, 128),
                            mask_shape=(24, 32), context_length=16, vocab_size=512, device="cpu")
    batch["binary_label_3d"][0] = 0.0
    batch["binary_label_3d"][1] = 1.0
    batch["point_valid"][1, 300:] = False
    model = build_train_model(cfg, tiny=True, seed=0, device="cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    statics = build_statics(model, cfg, device="cpu")
    mc = model.cfg
    draws = point_draws(torch.Generator().manual_seed(3), mc.dec_layers + 1, 2,
                        batch["target_labels"].shape[1], mc.num_points, mc.oversample_ratio,
                        mc.importance_sample_ratio, device="cpu")
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others,
                                                     TOTAL_STEPS))
    metrics = make_train_step(dict(cfg.loss_weight))(state, batch, statics, 1.0, draws=draws)
    adam = state.optimizer.adamw.state
    name = {id(p): n for n, p in model.named_parameters()}
    mu = {name[id(p)]: adam[m]["exp_avg"] for pairs in state.optimizer.pairs.values()
          for p, m in pairs}
    return ({"over": REDUCED, "state": start, "batch": batch, "statics": statics,
             "draws": draws, "total_steps": TOTAL_STEPS},
            {"metrics": metrics, "mu": mu, "buffers": dict(model.named_buffers())})


@pytest.fixture(scope="module")
def act_case(tmp_path_factory):
    """The JAX package's replicated UNet forward at 32^2 and VAE encode at
    64^2, the port's one-process references on the same weights, and the
    ranks' results."""
    tmp = tmp_path_factory.mktemp("act")
    rng = np.random.RandomState(0)
    x32 = rng.randn(1, 32, 32, 4).astype(np.float32)
    ctx32 = rng.randn(1, 77, UNET_TINY.context_dim).astype(np.float32)
    t32 = np.array([17])
    # seeded numpy weights on flax's shapes (its jitted init alone takes ~50 s here)
    junet = JUNet(UNET_TINY)
    uvars = random_variables(jax.eval_shape(junet.init, jax.random.PRNGKey(1), jnp.asarray(x32),
                                            jnp.asarray(t32), jnp.asarray(ctx32)), seed=1)
    j_unet = jax.device_get(jax.jit(junet.apply)(uvars, jnp.asarray(x32), jnp.asarray(t32),
                                                 jnp.asarray(ctx32)))
    img64 = rng.rand(1, 64, 64, 3).astype(np.float32)
    jvae = JVAE(VAE_TINY)
    vvars = random_variables(jax.eval_shape(jvae.init, jax.random.PRNGKey(2),
                                            jnp.zeros((1, 64, 64, 3))), seed=2)
    j_enc = jax.device_get(jax.jit(lambda v, x: jvae.apply(v, x, method=jvae.encode))(
        vvars, jnp.asarray(img64)))

    unet = SDUNet(UNET_TINY)
    load_jax_variables(unet, uvars)
    vae = AutoencoderKL(VAE_TINY)
    load_jax_variables(vae, vvars)
    d = {"unet": unet.state_dict(), "vae": vae.state_dict(), "x32": torch.from_numpy(x32),
         "t32": torch.from_numpy(t32), "ctx32": torch.from_numpy(ctx32),
         "x16": torch.from_numpy(rng.randn(1, 16, 16, 4).astype(np.float32)),
         "t16": torch.tensor([500]),
         "ctx16": torch.from_numpy(rng.randn(1, 16, UNET_TINY.context_dim).astype(np.float32)),
         "cond16": torch.from_numpy(
             0.3 * rng.randn(1, 4 * UNET_TINY.model_channels).astype(np.float32)),
         "img64": torch.from_numpy(img64),
         "lat7": torch.from_numpy(rng.randn(1, 7, 8, 4).astype(np.float32))}
    one = {}
    with torch.no_grad():
        one["unet32"] = unet(d["x32"], d["t32"], d["ctx32"], full=True)
        one["unet8"] = unet(d["x32"][:, :8, :8], d["t32"], d["ctx32"], full=True)
    one["grads"] = _grads(unet, d["x16"], d["t16"], d["ctx16"], d["cond16"])
    set_remat(unet, True)
    one["grads_remat"] = _grads(unet, d["x16"], d["t16"], d["ctx16"], d["cond16"])
    for fused in (False, True):
        v = AutoencoderKL(VAE_TINY, fused_gn=fused)
        v.load_state_dict(d["vae"])
        with torch.no_grad():
            one[f"encode_{fused}"] = v.encode(d["img64"])
            one[f"decode7_{fused}"] = v.decode(d["lat7"])
        if fused:
            latent, taps = v.encode(d["img64"])
            (latent.square().sum() + sum(t.square().sum() for t in taps)).backward()
            one["encode_grads"] = {n: p.grad for n, p in v.named_parameters()
                                   if p.grad is not None}
    train_in, one["step"] = _train_inputs()
    d.update(train_in)
    torch.save(d, tmp / "act_in.pt")
    ranks = spawn_ranks("act_shard", tmp, (), world=2, timeout=240.0)
    return {"one": one, "jax_unet": j_unet, "jax_encode": j_enc, "ranks": ranks, "in": d}


def _band_close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=BAND_ATOL, err_msg=what)


def _grad_close(got, want, what):
    rel = (got - want).abs() / want.abs().clamp(min=1.0)
    assert float(rel.max()) < GRAD_REL, f"{what}: {float(rel.max())}"


def _flat_unet(out):
    eps, taps = out
    return [eps, *taps]


def test_unet_forward_in_bands_equals_one_process_and_jax(act_case):
    r0, r1 = (r["unet32"] for r in act_case["ranks"])
    want = _flat_unet(act_case["one"]["unet32"])
    jax_out = [act_case["jax_unet"][0], *act_case["jax_unet"][1]]
    assert len(want) == 5
    for i, (a, b, w, j) in enumerate(zip(_flat_unet(r0), _flat_unet(r1), want, jax_out)):
        assert torch.equal(a, b), i  # the model group holds the same gathered outputs
        assert a.shape == w.shape, i
        _band_close(a, w, f"output {i}")
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=JAX_TOL, atol=JAX_TOL,
                                   err_msg=f"output {i} (JAX)")


def _check_grads(got, want, sliced=0):
    """`sliced`: parameters held as slices, whole without a sum."""
    assert got["summed"] == len(want["params"]) - sliced > 50
    for name, w in want["params"].items():
        _grad_close(got["params"][name], w, name)
    for k in ("context", "cond_emb"):
        assert float(want[k].abs().max()) > 0, k
        _grad_close(got[k], want[k], k)


@pytest.mark.parametrize("remat", [False, True])
def test_unet_gradients_in_bands_equal_one_process(act_case, remat):
    key = "grads_remat" if remat else "grads"
    ranks = act_case["ranks"]
    for k in ("context", "cond_emb"):
        assert torch.equal(ranks[0][key][k], ranks[1][key][k]), k
    _check_grads(ranks[0][key], act_case["one"][key])


def test_unet_gradients_with_tensor_parallelism_and_bands(act_case):
    """Sequence parallelism: the sharded layers' gathered rows, reduce-
    scattered sums and GEGLU's all-to-all; the backend forms agree bit for
    bit."""
    for r in act_case["ranks"]:
        _check_grads(r["grads_tp"], act_case["one"]["grads_remat"], sliced=r["sliced"])
        other = r["grads_tp_gloo_cuda_forms"]
        for k in ("context", "cond_emb"):
            assert torch.equal(other[k], r["grads_tp"][k]), k
        for n, g in r["grads_tp"]["params"].items():
            assert torch.equal(other["params"][n], g), n


@pytest.mark.parametrize("fused", [False, True])
def test_vae_encode_in_bands_equals_one_process_and_jax(act_case, fused):
    got = act_case["ranks"][0][f"encode_{fused}"]
    want = act_case["one"][f"encode_{fused}"]
    j_latent, j_taps = act_case["jax_encode"]
    for i, (a, w, j) in enumerate(zip([got[0], *got[1]], [want[0], *want[1]],
                                      [j_latent, *j_taps])):
        assert torch.equal(a, act_case["ranks"][1][f"encode_{fused}"][0] if i == 0
                           else act_case["ranks"][1][f"encode_{fused}"][1][i - 1]), i
        _band_close(a, w, f"encode output {i}")
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=JAX_TOL, atol=JAX_TOL,
                                   err_msg=f"encode output {i} (JAX)")
    assert len(got[1]) == 2


def test_fused_encode_gradients_in_bands_equal_one_process(act_case):
    got = act_case["ranks"][0]["encode_grads"]
    want = act_case["one"]["encode_grads"]
    assert got.keys() == want.keys() and len(want) > 50
    for name, w in want.items():
        _grad_close(got[name], w, name)


def test_indivisible_and_disabled_are_noops(act_case):
    one, d = act_case["one"], act_case["in"]
    for r in act_case["ranks"]:
        for a, w in zip(_flat_unet(r["unet8"]), _flat_unet(one["unet8"])):
            assert torch.equal(a, w)
        for a, w in zip(_flat_unet(r["unet32_off"]), _flat_unet(one["unet32"])):
            assert torch.equal(a, w)
        for fused in (False, True):
            rgb, taps = r[f"decode7_{fused}"]
            want_rgb, want_taps = one[f"decode7_{fused}"]
            assert torch.equal(rgb, want_rgb) and all(
                torch.equal(a, w) for a, w in zip(taps, want_taps))
        assert torch.equal(r["shard7"], d["x32"][:, :7])


def test_train_step_with_tensor_parallelism_and_bands_equals_one_process(act_case):
    ranks, one = act_case["ranks"], act_case["one"]["step"]
    got = ranks[0]["metrics"]
    for k, want in one["metrics"].items():
        assert torch.equal(ranks[1]["metrics"][k], got[k]), k
        if k.startswith("grad_norm"):
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=NORM_RTOL, err_msg=k)
        elif k.startswith("metric_"):
            assert torch.equal(got[k], want), k
        else:
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    assert float(one["metrics"]["loss_3d_contra"]) > 0
    top = max(float(v.abs().max()) for v in one["mu"].values())
    assert ranks[0]["mu"].keys() == one["mu"].keys() and len(one["mu"]) > 100
    for name, want in one["mu"].items():
        g = ranks[0]["mu"][name]
        assert torch.equal(ranks[1]["mu"][name], g), name
        if float(want.abs().max()) <= 1e-6 * top:
            assert float(g.abs().max()) <= 1e-6 * top, name
            continue
        l2 = float((g - want).norm() / want.norm())
        worst = float((g - want).abs().max() / want.abs().max())
        assert l2 <= GRAD_L2_TOL and worst <= GRAD_MAX_TOL, f"{name}: L2 {l2}, max {worst}"
    for name, want in one["buffers"].items():
        if want.is_floating_point():
            np.testing.assert_allclose(ranks[0]["buffers"][name].numpy(), want.numpy(), rtol=0,
                                       atol=STATS_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------


def test_band_check_and_no_ops():
    assert spatial.band_fits(32, 3, 2) and spatial.band_fits(64, 3, 4)
    assert not spatial.band_fits(8, 3, 2) and not spatial.band_fits(24, 3, 2)
    assert spatial.band_fits(8, 0, 2) and not spatial.band_fits(7, 0, 2)
    x = torch.ones(1, 8, 8, 3)
    with spatial.activation_sharding(None):
        assert spatial.sharding_mesh() is None and spatial.shard_spatial(x) is x
    with spatial.activation_sharding(Mesh(2, 1, 0, 0)):  # no model axis
        assert spatial.sharding_mesh() is None
        with spatial.banded(32, 3) as band:
            assert band is None
    mesh = Mesh(1, 2, 0, 0)  # no groups: only the decisions, no collective
    with spatial.activation_sharding(mesh):
        assert spatial.shard_spatial(torch.ones(1, 7, 8, 3)).shape[1] == 7
        assert spatial.shard_spatial(torch.ones(3)).shape == (3,)
        with spatial.banded(32, 3) as band:
            assert band is mesh and spatial.current_band() is mesh
        with spatial.banded(24, 3) as band:
            assert band is None
    assert spatial.sharding_mesh() is None and spatial.current_band() is None
    assert spatial.gather_rows(x) is x and spatial.copy_to_band(x) is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_band_pieces_equal_the_whole_map(dtype):
    """Rows split in two bands: the bands' moments merged in rank order
    give the whole map's affine, and each band's conv with one raw row of
    its neighbour (none at the map's edges) gives the whole conv's rows."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 12, 10, 32, generator=g) * 2 + 3).to(dtype)
    scale, bias = 1 + 0.2 * torch.randn(32, generator=g), 0.2 * torch.randn(32, generator=g)
    w, b = 0.1 * torch.randn(3, 3, 32, 24, generator=g), torch.randn(24, generator=g)
    whole = gn_conv.group_moments(x, 8)
    xd = x.double().reshape(2, 120, 8, 4)
    np.testing.assert_allclose(whole[..., 1].numpy(), xd.mean(dim=(1, 3)).numpy(), rtol=1e-12)
    np.testing.assert_allclose(whole[..., 2].numpy() / whole[..., 0].numpy(),
                               xd.var(dim=(1, 3), correction=0).numpy(), rtol=1e-10)
    parts = torch.stack([gn_conv.group_moments(x[:, :6].contiguous(), 8),
                         gn_conv.group_moments(x[:, 6:].contiguous(), 8)])
    a, s = gn_conv.affine_from_moments(parts, scale, bias)
    a1, s1 = gn_conv.affine_from_moments(whole[None], scale, bias)
    a_ref, s_ref = gn_conv.affine_from_stats(x, scale, bias, 8, 1e-6)
    for got in ((a, s), (a1, s1)):
        np.testing.assert_allclose(got[0].numpy(), a_ref.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), s_ref.numpy(), rtol=1e-6, atol=1e-5)
    full = gn_conv.affine_silu_conv(x, a, s, w, b)
    top = gn_conv.affine_silu_conv(x[:, :7].contiguous(), a, s, w, b)[:, :6]
    bottom = gn_conv.affine_silu_conv(x[:, 5:].contiguous(), a, s, w, b)[:, 1:]
    assert torch.equal(torch.cat([top, bottom], 1), full)
    ref = gn_conv.gn_silu_conv_reference(x, scale, bias, w, b, groups=8)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * float(ref.float().abs().max())
    np.testing.assert_allclose(full.float().numpy(), ref.float().numpy(), rtol=0, atol=tol)
