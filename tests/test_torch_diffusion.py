"""The port's diffusion sampling path against the JAX package.

- The beta schedules, `space_timesteps` and the respaced betas equal the
  JAX module's exactly (float64 numpy on both sides).
- `q_sample` and `eps_to_xstart` within 1e-6.
- The DDIM (eta 0 and 0.5) and DDPM loops with a toy eps-model, fed the
  JAX loop's own draws (its key chain reproduced with `jax.random`), within
  1e-5 of max(1, |x|). Without respacing the port hands the model the same
  timesteps as JAX; with respacing it hands it the original timestep of
  each respaced index (`timestep_map`), so it equals the JAX loop run with a
  model wrapper that maps t (ROADMAP C 11).
- The full `SDUNet` eps and `AutoencoderKL.decode` RGB (the tiny configs,
  the same weights through `load_jax_variables`) within rtol = atol =
  2e-3; the taps-only forwards return the taps of the full ones.
- `sample_images` (UNET_TINY / VAE_TINY, `ddim4`, CFG 7.5) against JAX's
  `sample_images` with the time-map wrapper within 2e-3, and apart from
  JAX's own (unmapped) result: C 11's pinning test.
- Both resamplers equal the JAX ones on one RandomState.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmask3d_tpu.models.diffusion as jdiff
import xmask3d_tpu.models.resample as jres
from xmask3d_tpu.models.sd_unet import SDUNet as JUNet
from xmask3d_tpu.models.txt2img import sample_images as jax_sample_images
from xmask3d_tpu.models.vae import AutoencoderKL as JVAE
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.models import diffusion as tdiff
from xmask3d_tpu_torch.models import resample as tres
from xmask3d_tpu_torch.models.sd_unet import SDUNet, UNET_TINY
from xmask3d_tpu_torch.models.txt2img import sample_images
from xmask3d_tpu_torch.models.vae import AutoencoderKL, VAE_TINY


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEDULES = ("linear", "ldm_linear", "cosine")
RESPACINGS = (None, "ddim50", "ddim4", "10,15,20", "250")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("steps", [1000, 40])
def test_betas_equal_jax(schedule, steps):
    np.testing.assert_array_equal(tdiff.make_betas(schedule, steps),
                                  jdiff.make_betas(schedule, steps))


@pytest.mark.parametrize("counts", ["ddim50", "ddim4", "ddim1000", "10,15,20", "250", [7, 3, 1]])
def test_space_timesteps_equal_jax(counts):
    assert list(tdiff.space_timesteps(1000, counts)) == list(jdiff.space_timesteps(1000, counts))


def test_space_timesteps_refuses_what_jax_refuses():
    for counts in ("ddim999", "600,600"):
        with pytest.raises(ValueError):
            jdiff.space_timesteps(1000, counts)
        with pytest.raises(ValueError):
            tdiff.space_timesteps(1000, counts)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("respacing", RESPACINGS)
def test_respaced_schedule_equals_jax(schedule, respacing):
    got = tdiff.GaussianDiffusion.create(1000, schedule, respacing)
    want = jdiff.GaussianDiffusion.create(1000, schedule, respacing)
    np.testing.assert_array_equal(got.betas, want.betas)
    np.testing.assert_array_equal(got.alphas_cumprod, want.alphas_cumprod)
    assert got.num_timesteps == want.num_timesteps
    used = sorted(tdiff.space_timesteps(1000, respacing)) if respacing else range(1000)
    np.testing.assert_array_equal(got.timestep_map, np.asarray(used))


@pytest.mark.parametrize("respacing", [None, "ddim50"])
def test_q_sample_and_eps_to_xstart_match_jax(respacing):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    eps = rng.randn(3, 8, 8, 4).astype(np.float32)
    port = tdiff.GaussianDiffusion.create(1000, "ldm_linear", respacing)
    ref = jdiff.GaussianDiffusion.create(1000, "ldm_linear", respacing)
    t = np.array([0, port.num_timesteps // 2, port.num_timesteps - 1])
    for name in ("q_sample", "eps_to_xstart"):
        got = getattr(port, name)(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(eps)).numpy()
        want = np.asarray(getattr(ref, name)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _toy_eps(x, t, lib):
    """A smooth eps-model of the latent and the timestep (torch or jnp)."""
    tf = t.astype(jnp.float32) if lib is jnp else t.float()
    s = lib.sin(tf / 97.0).reshape((-1, 1, 1, 1))
    return 0.3 * lib.tanh(x) * (1.0 + s) + 0.05 * s


def _jax_draws(key, shape, n):
    """The draws of the JAX loops' key chain: x_T, then one a step."""
    key, k0 = jax.random.split(key)
    x_t = np.array(jax.random.normal(k0, shape, jnp.float32))
    steps = []
    for _ in range(n):
        key, kn = jax.random.split(key)
        steps.append(torch.from_numpy(np.array(jax.random.normal(kn, shape, jnp.float32))))
    return torch.from_numpy(x_t), steps


@pytest.mark.parametrize("loop,kw", [
    ("ddim_sample_loop", {"eta": 0.0}), ("ddim_sample_loop", {"eta": 0.5}),
    ("ddim_sample_loop", {"eta": 0.0, "clip_denoised": True}), ("p_sample_loop", {}),
])
@pytest.mark.parametrize("schedule,steps,respacing", [
    ("ldm_linear", 20, None), ("cosine", 25, None), ("ldm_linear", 1000, "ddim10"),
    ("linear", 1000, "5,3"),
])
def test_loops_match_jax_given_its_draws(loop, kw, schedule, steps, respacing):
    port = tdiff.GaussianDiffusion.create(steps, schedule, respacing)
    ref = jdiff.GaussianDiffusion.create(steps, schedule, respacing)
    tmap = jnp.asarray(port.timestep_map)
    shape = (2, 6, 6, 4)
    key = jax.random.PRNGKey(7)
    want = np.asarray(getattr(ref, loop)(lambda x, t: _toy_eps(x, tmap[t], jnp), shape, key, **kw))
    got = getattr(port, loop)(lambda x, t: _toy_eps(x, t, torch), shape,
                              noise=_jax_draws(key, shape, port.num_timesteps), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    if respacing is None:  # the identity map: JAX's own loop, unwrapped
        plain = np.asarray(getattr(ref, loop)(lambda x, t: _toy_eps(x, t, jnp), shape, key, **kw))
        np.testing.assert_array_equal(plain, want)


def test_loops_draw_from_the_generator():
    """With a generator (no pre-drawn noise) the same seed gives the same
    sample, another seed another; DDIM at eta 0 draws only x_T."""
    diff = tdiff.GaussianDiffusion.create(1000, "ldm_linear", "ddim5")
    shape = (1, 4, 4, 4)

    def run(seed, loop="p_sample_loop"):
        g = torch.Generator().manual_seed(seed)
        out = getattr(diff, loop)(lambda x, t: _toy_eps(x, t, torch), shape, g)
        return out, g

    a, _ = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    _, g = run(0, "ddim_sample_loop")
    after_x_t = torch.Generator().manual_seed(0)
    torch.randn(shape, generator=after_x_t)
    assert torch.equal(torch.randn(3, generator=g), torch.randn(3, generator=after_x_t))


def _perturbed(variables, seed):
    """flax's init with every vector leaf (biases, norm scales) moved off its
    constant, so no term of the forward vanishes."""
    rng = np.random.RandomState(seed)

    def f(a):
        a = np.asarray(a)
        if a.ndim == 1:
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a.astype(np.float32)

    return jax.tree_util.tree_map(f, jax.device_get(variables))


@pytest.fixture(scope="module")
def unet_pair():
    ref = JUNet(UNET_TINY)
    x = jnp.zeros((2, 8, 8, 4))
    ctx = jnp.zeros((2, 16, UNET_TINY.context_dim))
    # flax's init: moving its vector leaves off their constants makes the
    # tiny UNet's taps 10x more sensitive to rounding (first tap 0.014 apart
    # at a largest value of 5.7, against 8e-4 here)
    variables = jax.device_get(jax.jit(ref.init)(jax.random.PRNGKey(1), x,
                                                 jnp.zeros((2,), jnp.int32), ctx))
    port = SDUNet(UNET_TINY).eval()
    load_jax_variables(port, variables)
    return ref, variables, port


@pytest.fixture(scope="module")
def vae_pair():
    ref = JVAE(VAE_TINY)
    variables = _perturbed(jax.jit(ref.init)(jax.random.PRNGKey(2),
                                             jnp.zeros((1, 64, 64, 3))), 2)
    return ref, variables


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_unet_full_forward_matches_jax(unet_pair):
    ref, variables, port = unet_pair
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([999, 17])
    ctx = rng.randn(2, 16, UNET_TINY.context_dim).astype(np.float32)
    want_eps, want_taps = ref.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        eps, taps = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         full=True)
        taps_only = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert eps.shape == (2, 8, 8, 4)
    _close(eps.numpy(), np.asarray(want_eps))
    assert len(taps) == len(taps_only) == len(want_taps) == 4
    for a, b, w in zip(taps_only, taps, want_taps):
        assert torch.equal(a, b)
        _close(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("fused_gn", [False, True])
def test_vae_decode_matches_jax(vae_pair, fused_gn):
    ref, variables = vae_pair
    port = AutoencoderKL(VAE_TINY, fused_gn=fused_gn).eval()
    load_jax_variables(port, variables)
    lat = np.random.RandomState(4).randn(1, 8, 8, 4).astype(np.float32)
    want_rgb, want_taps = ref.apply(variables, jnp.asarray(lat), method=ref.decode)
    with torch.no_grad():
        rgb, taps = port.decode(torch.from_numpy(lat))
        taps_only = port.decode_taps(torch.from_numpy(lat))
    assert rgb.shape == (1, 64, 64, 3)
    _close(rgb.numpy(), np.asarray(want_rgb))
    for a, b, w in zip(taps_only, taps, want_taps):
        assert torch.equal(a, b)
        _close(a.numpy(), np.asarray(w))


def test_sample_images_matches_jax_with_the_time_map(unet_pair, vae_pair):
    """C 11: JAX's `ddim_sample_loop` hands the UNet the respaced index; the
    port the original timestep. Wrapped with the map, JAX's sampler gives
    the port's images; its own result differs."""
    ref_unet, u_vars, unet = unet_pair
    ref_vae, v_vars = vae_pair
    vae = AutoencoderKL(VAE_TINY).eval()
    load_jax_variables(vae, v_vars)
    rng = np.random.RandomState(5)
    cond = rng.randn(1, 16, UNET_TINY.context_dim).astype(np.float32)
    uncond = rng.randn(1, 16, UNET_TINY.context_dim).astype(np.float32)
    diff = tdiff.GaussianDiffusion.create(1000, "ldm_linear", "ddim4")
    jdf = jdiff.GaussianDiffusion.create(1000, "ldm_linear", "ddim4")
    tmap = jnp.asarray(diff.timestep_map)
    key = jax.random.PRNGKey(6)

    def jax_images(mapped):
        def unet_apply(x, t, c):
            return ref_unet.apply(u_vars, x, tmap[t] if mapped else t, c)

        return np.asarray(jax_sample_images(
            unet_apply, lambda z: ref_vae.apply(v_vars, z, method=ref_vae.decode), jdf,
            jnp.asarray(cond), jnp.asarray(uncond), key, latent_hw=(8, 8), guidance_scale=7.5))

    want = jax_images(True)
    got = sample_images(unet, vae, diff, torch.from_numpy(cond), torch.from_numpy(uncond),
                        latent_hw=(8, 8), guidance_scale=7.5,
                        noise=_jax_draws(key, (1, 8, 8, 4), 0)).numpy()
    assert got.shape == (1, 64, 64, 3) and got.min() >= 0.0 and got.max() <= 1.0
    _close(got, want)
    assert np.abs(jax_images(False) - want).max() > 1e-2


def test_resamplers_equal_jax():
    for cls in ("UniformSampler", "LossSecondMomentResampler"):
        port, ref = getattr(tres, cls)(6), getattr(jres, cls)(6)
        rs_port, rs_ref = np.random.RandomState(0), np.random.RandomState(0)
        losses = np.random.RandomState(1)
        for _ in range(30):
            t_p, w_p = port.sample(4, rs_port)
            t_r, w_r = ref.sample(4, rs_ref)
            np.testing.assert_array_equal(t_p, t_r)
            np.testing.assert_array_equal(w_p, w_r)
            assert t_p.dtype == t_r.dtype and w_p.dtype == w_r.dtype
            np.testing.assert_array_equal(port.weights(), ref.weights())
            if hasattr(port, "update_with_losses"):
                ls = losses.rand(4) * (1 + t_p)
                port.update_with_losses(t_p, ls)
                ref.update_with_losses(t_r, ls)
        if cls == "LossSecondMomentResampler":
            assert port._warmed_up() and ref._warmed_up()
