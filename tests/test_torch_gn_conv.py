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
from xmask3d_tpu_torch.ops import gn_conv as tgc
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
    """K4's bf16 conv reads w HWIO as [64-channel chunk][tap = 3 dy + dx]
    [8-channel group][C_out padded to 128][8 channels], zero past C and
    C_out; its fp32 conv as (tap, C_out, C)."""
    _, _, _, w, b = (_t(a) for a in _data(bsz=1, h=2, wd=2, c=72, cout=136, seed=3))
    wk, bf = kernel_params(w, b, torch.bfloat16)
    assert wk.shape == (2, 9, 8, 256, 8) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert bf.dtype == torch.float32 and torch.equal(bf, b)
    wb = w.to(torch.bfloat16)
    for dy in range(3):
        for dx in range(3):
            # (C, C_out) of the tap, rebuilt from the chunks and channel groups
            tap = wk[:, 3 * dy + dx].permute(0, 1, 3, 2).reshape(128, 256)
            assert torch.equal(tap[:72, :136], wb[dy, dx])
            assert not tap[72:].any() and not tap[:, 136:].any()
    wk, bf = kernel_params(w, b, torch.float32)
    assert wk.shape == (9, 136, 72) and wk.dtype == torch.float32 and wk.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(wk[3 * dy + dx], w[dy, dx].t())


# --------------------------------------------------------------------------
# the kernels' plans and the statistics' arithmetic (pure functions)
# --------------------------------------------------------------------------

# the VAE's K4 calls at 512 x 512 (B = 1): rows, columns, C, C_out, conv variant
PATH_SHAPES = [(512, 512, 128, 128, "wgmma_n128"), (256, 256, 128, 256, "wgmma_n128"),
               (256, 256, 256, 256, "wgmma_n128"), (128, 128, 256, 512, "wgmma_n128"),
               (128, 128, 512, 512, "wgmma_n128"), (64, 64, 512, 512, "wgmma_n64")]


@pytest.mark.parametrize("h,wd,c,cout,want", PATH_SHAPES)
def test_kernel_plan_on_the_path(h, wd, c, cout, want):
    """bf16 takes the tensor-core conv with 128 output channels a block where
    the grid of 4 x 64-pixel tiles fills the card's 132 SMs, 64 where it
    would not (the 64^2 maps: 16 tiles x 4 blocks of 128 channels); fp32
    takes the CUDA-core conv. The statistics read x in 16-byte loads with at
    most 1024 blocks a batch of contiguous pixel ranges that cover it."""
    name, bn = tgc.kernel_plan(torch.bfloat16, 1, h, wd, cout)
    assert name == want and bn == int(want[len("wgmma_n"):])
    tiles = -(-h // tgc.TILE_ROWS) * -(-wd // tgc.TILE_COLS)
    blocks = tiles * -(-cout // bn)
    assert blocks >= tgc.SM_COUNT or bn == 64
    if bn == 64:
        assert tiles * -(-cout // 128) < tgc.SM_COUNT
    assert tgc.kernel_plan(torch.float32, 1, h, wd, cout) == ("fma_fp32", 0)
    x = torch.zeros(1, h, wd, c, dtype=torch.bfloat16)
    assert tgc.variant(x, torch.zeros(3, 3, c, cout)) == want
    n_blocks, ppb, vec = tgc.stats_plan(h * wd, c, torch.bfloat16)
    assert vec == 8 and n_blocks <= 1024
    assert (n_blocks - 1) * ppb < h * wd <= n_blocks * ppb


@pytest.mark.parametrize("hw,c,dtype,aligned,vec", [
    (40 * 48, 128, torch.bfloat16, True, 8), (40 * 48, 128, torch.float32, True, 4),
    (9 * 13, 20, torch.bfloat16, True, 1), (9 * 13, 20, torch.float32, True, 4),
    (7, 48, torch.bfloat16, False, 1), (5, 2048, torch.bfloat16, True, 8),
    (64 * 64, 512, torch.bfloat16, False, 1), (64 * 64, 512, torch.float32, False, 1),
    (9 * 13, 260, torch.bfloat16, True, 1), (5, 4096, torch.bfloat16, True, 8),
])
def test_stats_plan_counts(hw, c, dtype, aligned, vec):
    """Loads of 16 bytes only where C and the pointer allow; every block
    gets at least one pixel and the blocks cover the map; any width, the
    VAE's 512 channels off 16 bytes included (a thread then takes several
    of a pixel row's channel slots)."""
    n_blocks, ppb, got = tgc.stats_plan(hw, c, dtype, aligned)
    assert got == vec and c % got == 0
    assert 1 <= n_blocks <= 1024 and (n_blocks - 1) * ppb < hw <= n_blocks * ppb


def _affine_in_kernel_order(x, scale, bias, groups, eps, aligned=True):
    """`gn_stats_kernel` and `gn_affine_kernel` step by step in PyTorch:
    `stats_plan`'s pixel ranges, each thread's Welford moments of its
    channels over every rows-th pixel accumulated in fp32 as the kernel
    does, the block's merge per group by Chan's formula in fp64, the same
    merge over the blocks, then a and s rounded once to fp32."""
    bsz, h, wd, c = x.shape
    hw, cg = h * wd, c // groups
    n_blocks, ppb, vec = tgc.stats_plan(hw, c, x.dtype, aligned)
    rows = max(1, tgc.STATS_THREADS // (c // vec))
    steps = -(-ppb // rows)
    # pixel of (block, step, row): the thread of row r takes p0 + r + t * rows
    pix = (torch.arange(n_blocks)[:, None, None] * ppb + torch.arange(steps)[None, :, None] * rows
           + torch.arange(rows)[None, None, :])
    inside = (pix < hw) & ((pix - torch.arange(n_blocks)[:, None, None] * ppb) < ppb)
    xs = x.float().reshape(bsz, hw, c)[:, pix.clamp(max=hw - 1)]  # (B, P, T, R, C)
    n = torch.zeros(n_blocks, rows)
    mean = torch.zeros(bsz, n_blocks, rows, c)
    m2 = torch.zeros(bsz, n_blocks, rows, c)
    for t in range(steps):
        ok = inside[:, t]  # (P, R)
        n_new = torch.where(ok, n + 1.0, n)
        inv = (1.0 / n_new.clamp(min=1.0))[None, :, :, None]
        v = xs[:, :, t]
        delta = v - mean
        mean_new = delta * inv + mean
        m2_new = delta * (v - mean_new) + m2
        keep = ok[None, :, :, None]
        mean, m2, n = torch.where(keep, mean_new, mean), torch.where(keep, m2_new, m2), n_new
    # block merge, fp64: parts are (row, channel) of the group
    cnt = n.double()[None, :, :, None, None]  # (1, P, R, 1, 1)
    mean_p = mean.double().reshape(bsz, n_blocks, rows, groups, cg)
    m2_p = m2.double().reshape(bsz, n_blocks, rows, groups, cg)
    n_k = (cnt * torch.ones_like(mean_p)).sum(dim=(2, 4))  # (B, P, G)
    mean_k = (cnt * mean_p).sum(dim=(2, 4)) / n_k
    m2_k = (m2_p + cnt * (mean_p - mean_k[:, :, None, :, None]).square()).sum(dim=(2, 4))
    # merge over the blocks
    mean_g = (n_k * mean_k).sum(dim=1) / (hw * cg)  # (B, G)
    m2_g = (m2_k + n_k * (mean_k - mean_g[:, None]).square()).sum(dim=1)
    inv_std = 1.0 / torch.sqrt(torch.clamp(m2_g / (hw * cg), min=0.0) + eps)
    a = inv_std[..., None] * scale.double().reshape(groups, cg)
    s = bias.double().reshape(groups, cg) - mean_g[..., None] * a
    return a.reshape(bsz, c).float(), s.reshape(bsz, c).float()


@pytest.mark.parametrize("loc,spread,shape", [
    (30.0, 0.5, (2, 40, 48, 128)), (0.0, 1.0, (2, 16, 24, 256)), (-2.0, 3.0, (1, 9, 13, 64)),
])
def test_blocked_statistics_match_jax(loc, spread, shape):
    """The statistics kernels' arithmetic in their order (fp32 per-thread
    Welford, fp64 merges), in PyTorch, against the JAX package's
    `_affine_from_stats` and against float64, at a large mean over a small
    spread and at unit scale, in bf16 and in fp32, with 16-byte and with
    scalar loads (which change the threads' rows)."""
    rng = np.random.RandomState(int(loc) + shape[3])
    x = (loc + spread * rng.randn(*shape)).astype(np.float32)
    c = shape[3]
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    ja, js = _affine_from_stats(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6)
    xd = x.astype(np.float64).reshape(shape[0], -1, 32, c // 32)
    mean, var = xd.mean(axis=(1, 3)), xd.var(axis=(1, 3))
    a64 = (scale.reshape(32, -1) / np.sqrt(var + 1e-6)[..., None]).reshape(shape[0], c)
    s64 = (bias.reshape(32, -1) - mean[..., None] * a64.reshape(shape[0], 32, -1)).reshape(shape[0], c)
    for aligned in (True, False):
        a, s = _affine_in_kernel_order(_t(x), _t(scale), _t(bias), 32, 1e-6, aligned)
        assert a.dtype == torch.float32 and a.shape == (shape[0], c)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
        assert np.abs(a.numpy() - a64).max() <= 1e-6 * np.abs(a64).max()
        assert np.abs(s.numpy() - s64).max() <= 1e-6 * np.abs(s64).max()
    # bf16 x: the kernel reads bf16 values and accumulates them in fp32
    xb = _t(x).bfloat16()
    xbd = xb.double().numpy().reshape(shape[0], -1, 32, c // 32)
    mean, var = xbd.mean(axis=(1, 3)), xbd.var(axis=(1, 3))
    a64 = (scale.reshape(32, -1) / np.sqrt(var + 1e-6)[..., None]).reshape(shape[0], c)
    a, _ = _affine_in_kernel_order(xb, _t(scale), _t(bias), 32, 1e-6)
    assert np.abs(a.numpy() - a64).max() <= 1e-6 * np.abs(a64).max()


def test_kernel_order_statistics_at_the_vae_width_off_16_bytes():
    """512 channels read by scalar loads (x off 16 bytes): 512 channel slots
    a pixel row for 256 threads, so each thread takes two in turn; the
    kernel's arithmetic against `affine_from_stats` and float64."""
    rng = np.random.RandomState(5)
    x = _t((30.0 + 0.5 * rng.randn(1, 6, 10, 512)).astype(np.float32))
    scale, bias = _t(rng.rand(512).astype(np.float32) + 0.5), _t(rng.randn(512).astype(np.float32))
    assert tgc.stats_plan(60, 512, torch.float32, aligned=False)[2] == 1
    a, s = _affine_in_kernel_order(x, scale, bias, 32, 1e-6, aligned=False)
    ar, sr = affine_from_stats(x, scale, bias, 32, 1e-6)
    torch.testing.assert_close(a, ar, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s, sr, rtol=1e-5, atol=1e-6)


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
