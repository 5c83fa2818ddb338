"""The port's GroupNorm and its GroupNorm -> SiLU -> conv3x3 (K4's plain
version, and the VAE resblock that calls it) against the JAX package.

Shapes and tolerances follow tests/test_gn_conv.py: 2e-4 in fp32 and 2e-2 in
bf16 for the conv (op order differs; bf16 outputs may sit one ulp apart),
1e-4 for the resblock, 1e-5 for GroupNorm against flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import xmask3d_tpu.models.vae as jvae
from xmask3d_tpu.ops.gn_conv import _affine_from_stats, _fused_forward
from xmask3d_tpu.ops.gn_conv import gn_silu_conv_reference as jax_reference
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.models import layers
from xmask3d_tpu_torch.models.vae import ResnetBlock
from xmask3d_tpu_torch.ops import _build
from xmask3d_tpu_torch.ops.gn_conv import (
    affine_from_stats,
    gn_silu_conv,
    gn_silu_conv_reference,
    kernel_params,
)

DTYPES = [(jnp.float32, torch.float32, 2e-4), (jnp.bfloat16, torch.bfloat16, 2e-2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(bsz=2, h=32, wd=128, c=128, cout=128, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, h, wd, c).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(3, 3, c, cout) * 0.05).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# GroupNorm, computed as flax computes it
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,values", [
    ((2, 1, 1, 32), 1),    # one value a group
    ((2, 1, 2, 32), 2),    # two pixels x one channel
    ((2, 1, 1, 64), 2),    # one pixel x two channels
    ((2, 4, 4, 128), 64),  # sixteen pixels x four channels
])
def test_group_norm_matches_flax(shape, values):
    """Groups of 1, 2 and 64 values. The small groups sit at a large mean
    with a small spread, where flax's one-pass variance and a two-pass one
    part far beyond the tolerance."""
    c = shape[-1]
    groups = layers.gn_groups(c)
    assert np.prod(shape[1:3]) * c // groups == values
    rng = np.random.RandomState(values)
    if values <= 2:
        x = (30.0 + 0.05 * rng.randn(*shape)).astype(np.float32)
    else:
        x = (3.0 * rng.randn(*shape) + 1.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    want = np.asarray(fnn.GroupNorm(num_groups=groups).apply(
        {"params": {"scale": scale, "bias": bias}}, x))
    gn = layers.GroupNorm(c)
    with torch.no_grad():
        gn.weight.copy_(_t(scale))
        gn.bias.copy_(_t(bias))
        got = gn(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_group_norm_keeps_bf16_and_its_parameters():
    gn = layers.GroupNorm(64).to(torch.bfloat16)
    assert [n for n, _ in gn.named_parameters()] == ["weight", "bias"]
    x = torch.randn(1, 3, 5, 64).to(torch.bfloat16)
    assert gn(x).dtype == torch.bfloat16


# --------------------------------------------------------------------------
# K4's plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,wd,th", [(32, 128, 16), (16, 256, 4), (8, 128, 8)])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_reference_matches_jax_reference_and_pallas_kernel(h, wd, th, jdt, tdt, tol):
    """The port's plain version against JAX's oracle and JAX's Pallas kernel
    in interpret mode, B = 2 (per-batch statistics)."""
    x, scale, bias, w, b = _data(h=h, wd=wd, seed=h + wd)
    xj = jnp.asarray(x, jdt)
    args = (jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(w), jnp.asarray(b))
    oracle = np.asarray(jax_reference(xj, *args), np.float32)
    pallas = np.asarray(_fused_forward(xj, *args, 32, 1e-6, th, interpret=True), np.float32)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(tdt)
    got = gn_silu_conv_reference(xt, _t(scale), _t(bias), _t(w), _t(b))
    assert got.dtype == tdt and got.shape == (2, h, wd, 128)
    got = got.float().numpy()
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    # the SAME padding pads the normalised tensor: the borders are held as
    # strictly as the interior
    for edge in (got[:, 0] - oracle[:, 0], got[:, -1] - oracle[:, -1],
                 got[:, :, 0] - oracle[:, :, 0], got[:, :, -1] - oracle[:, :, -1]):
        assert np.abs(edge).max() <= tol * max(1.0, np.abs(oracle).max())


def test_affine_from_stats_matches_jax():
    x, scale, bias, _, _ = _data(h=8, wd=16, seed=1)
    ja, js = _affine_from_stats(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6)
    a, s = affine_from_stats(_t(x), _t(scale), _t(bias), 32, 1e-6)
    assert a.shape == s.shape == (2, 128) and a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version: same result, the
    recorder hook sees the call, no launch is counted; bad inputs raise."""
    x, scale, bias, w, b = (_t(a) for a in _data(bsz=1, h=5, wd=7, c=16, cout=24, seed=2))
    seen = []
    n = gn_silu_conv.launches
    _build.RECORDER = lambda name, args: seen.append((name, args))
    try:
        got = gn_silu_conv(x, scale, bias, w, b, groups=4)
    finally:
        _build.RECORDER = None
    assert gn_silu_conv.launches == n
    assert [s[0] for s in seen] == ["gn_silu_conv"] and seen[0][1][5:] == (4, 1e-6)
    torch.testing.assert_close(got, gn_silu_conv_reference(x, scale, bias, w, b, 4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="groups"):
        gn_silu_conv(x, scale, bias, w, b, groups=5)
    with pytest.raises(ValueError):
        gn_silu_conv(x, scale, bias, w[:, :, :8], b, groups=4)
    with pytest.raises(ValueError, match="contiguous"):
        gn_silu_conv(x.transpose(1, 2), scale, bias, w, b, groups=4)
    with pytest.raises(TypeError):
        gn_silu_conv(x.double(), scale, bias, w, b, groups=4)


def test_kernel_params_layout():
    """K4 reads w HWIO as (tap, C_out, C): tap = 3 * dy + dx."""
    _, _, _, w, b = (_t(a) for a in _data(bsz=1, h=2, wd=2, c=16, cout=24, seed=3))
    wk, bf = kernel_params(w, b, torch.bfloat16)
    assert wk.shape == (9, 24, 16) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert bf.dtype == torch.float32 and torch.equal(bf, b)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(wk[3 * dy + dx], w[dy, dx].t().to(torch.bfloat16))


# --------------------------------------------------------------------------
# the fused resblock
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(128, 128), (64, 128)])
def test_fused_resnet_block_matches_jax(monkeypatch, cin, cout):
    """The port's ResnetBlock with fused_gn against JAX's with its fused
    branch forced on (which runs the oracle off the TPU): the same parameter
    tree, the same weights, within 1e-4."""
    rng = np.random.RandomState(cin)
    x = rng.randn(1, 16, 32, cin).astype(np.float32)
    block = jvae.ResnetBlock(out_ch=cout)
    monkeypatch.setattr(jvae, "fused_available", lambda *a, **k: True)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), x)
    variables = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * (0.05 if len(s.shape) == 4 else 0.3) + (
            1.0 if len(s.shape) == 1 else 0.0)).astype(np.float32), shapes)
    want = np.asarray(block.apply(variables, x))
    port = ResnetBlock(cin, cout, fused_gn=True)
    assert set(port.state_dict()) == set(ResnetBlock(cin, cout).state_dict())
    load_jax_variables(port, jax.device_get(variables))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
