"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a GPU and skips
without one. The file imports nothing of JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py

Tolerances on max |kernel - plain| relative to max(1, max |plain|): 1e-5 in
fp32 (summation order only), 2^-7 in bf16 (two ulps of the output).
"""

import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.models.layers import GroupNorm, gn_groups
from xmask3d_tpu_torch.ops import deform_attn as tda
from xmask3d_tpu_torch.ops import flash_attention as tfa
from xmask3d_tpu_torch.ops import gn_conv as tgc
from xmask3d_tpu_torch.ops import sparse_conv as tsc

pytestmark = pytest.mark.gpu
DTYPES = ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # the plain versions' fp32 convolutions in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(fn, plain, args, kwargs, tol):
    n = fn.launches
    got = fn(*args, **kwargs).float()
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    ref = plain(*args, **kwargs).float()
    err = float((got - ref).abs().max())
    assert err <= tol * max(1.0, float(ref.abs().max())), err


@pytest.mark.parametrize("kernel,cin,cout", [(5, 3, 64), (3, 96, 128), (3, 384, 128), (3, 256, 256),
                                             (3, 13, 7), (2, 32, 32), (3, 64, 96), (3, 40, 320)])
def test_sparse_conv(cuda, kernel, cin, cout):
    """Stem (125 taps, C_in 3), k3 at the path's widest layers, odd widths, a
    width that tiles C_out over the grid and a stride-2 down map, with missing
    neighbours, all-padding tiles and `out_valid`."""
    rng = np.random.RandomState(kernel + cin)
    coords = np.unique(rng.randint(0, 24, size=(3000, 3)).astype(np.int32), axis=0)
    caps = (4096, 2048, 1024, 512, 256)
    h = tsc.build_hierarchy(coords, caps)
    kmap = {5: h.kmap5, 3: h.kmap3[0], 2: h.down[0]}[kernel][None]
    v_out = kmap.shape[2]
    feats = torch.from_numpy(rng.randn(1, caps[0], cin).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(kmap.shape[1], cin, cout).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(np.arange(v_out) < int(h.num[1 if kernel == 2 else 0]))[None].to(cuda)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    kmap = torch.from_numpy(kmap).to(cuda)
    for dt, tol in DTYPES:
        name = tsc.variant(feats.to(dt), w.to(dt), kmap)
        assert name.startswith("mma_") == (dt == torch.bfloat16), name
        _close(tsc.sparse_conv, tsc.sparse_conv_reference,
               (feats.to(dt), w.to(dt), kmap), dict(bias=bias, out_valid=valid), tol)
        _close(tsc.sparse_conv, tsc.sparse_conv_reference, (feats.to(dt), w.to(dt), kmap), {}, tol)


def test_sparse_conv_sparse_strips_batch_and_misaligned_views(cuda):
    """B = 2 with different maps; whole 16-row strips and 64-row tiles without
    a hit or a live row among live ones; a dead row whose map entries point at
    NaN features; and feature / weight views off 16 bytes, which take the
    packed mode of the same width."""
    rng = np.random.RandomState(7)
    b, v, cin, cout, k = 2, 640, 32, 64, 27
    kmap = rng.randint(0, 600, size=(b, k, v)).astype(np.int32)
    kmap[rng.rand(b, k, v) < 0.7] = -1
    kmap[:, :, 16:48] = -1          # two strips of a live tile hit nothing
    kmap[:, 5:20, 128:192] = -1     # a tile that skips most taps
    valid = np.ones((b, v), bool)
    valid[:, 256:384] = False       # two dead tiles
    valid[0, 3] = valid[1, 70] = False
    feats = rng.randn(b, v, cin).astype(np.float32)
    kmap[0, :, 3], kmap[1, :, 70] = 600, 601
    feats[:, 600:602] = np.nan      # referenced by dead rows only
    w = torch.from_numpy(rng.randn(k, cin, cout).astype(np.float32)).to(cuda)
    feats, kmap, valid = (torch.from_numpy(a).to(cuda) for a in (feats, kmap, valid))
    steps, hit = tsc.strip_tap_steps(kmap, valid)
    assert 0 < hit < steps
    for dt, tol in DTYPES:
        args = (feats.to(dt), w.to(dt), kmap)
        _close(tsc.sparse_conv, tsc.sparse_conv_reference, args, dict(out_valid=valid), tol)
        if dt == torch.bfloat16:
            fbuf = torch.zeros(feats.numel() + 1, dtype=dt, device=cuda)
            wbuf = torch.zeros(w.numel() + 1, dtype=dt, device=cuda)
            fbuf[1:] = args[0].reshape(-1)
            wbuf[1:] = args[1].reshape(-1)
            off = (fbuf[1:].view(feats.shape), wbuf[1:].view(w.shape), kmap)
            assert off[0].data_ptr() % 16 and off[0].is_contiguous()
            _close(tsc.sparse_conv, tsc.sparse_conv_reference, off, dict(out_valid=valid), tol)


# every shape class of the full-width path (SD UNet self- and cross-attention
# at 8 heads, the 64-token mid block, the VAE's single 512-wide head), ragged
# edges on both sides, and head dims off the 8-value copy width
K2_SHAPES = [(4096, 4096, 40, 8), (4096, 77, 40, 8), (1024, 1024, 80, 8), (1024, 77, 80, 8),
             (256, 77, 160, 8), (64, 64, 160, 8), (4096, 4096, 512, 1), (1000, 300, 40, 2),
             (100, 130, 36, 2), (70, 77, 20, 3), (50, 200, 200, 1), (300, 1000, 128, 2)]


@pytest.mark.parametrize("tq,tk,d,h", K2_SHAPES)
def test_flash_attention(cuda, tq, tk, d, h):
    rng = np.random.RandomState(tq + d)
    q, k, v = (torch.from_numpy(rng.randn(1, h, t, d).astype(np.float32)).to(cuda)
               for t in (tq, tk, tk))
    for dt, tol in DTYPES:
        args = (q.to(dt), k.to(dt), v.to(dt))
        name = tfa.variant(args[0], args[1])
        assert name.startswith("mma_") == (dt == torch.bfloat16), name
        _close(tfa.attention, tfa.reference_attention, args, {}, tol)


@pytest.mark.parametrize("tq,tk,d,h", [(256, 300, 40, 2), (128, 77, 80, 2), (64, 200, 512, 1)])
def test_flash_attention_near_one_hot(cuda, tq, tk, d, h):
    """A few large scores: the softmax is close to one-hot, so the running
    max moves late and by a lot, and most probabilities underflow to 0."""
    rng = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rng.randn(1, h, t, d).astype(np.float32)).to(cuda)
               for t in (tq, tk, tk))
    n = min(tq, tk)
    k[:, :, :n] += 6.0 * q[:, :, :n]  # query i scores ~6 sqrt(d) on key i
    for dt, tol in DTYPES:
        _close(tfa.attention, tfa.reference_attention, (q.to(dt), k.to(dt), v.to(dt)), {}, tol)


@pytest.mark.parametrize("tq,tk,d", [(200, 77, 40), (100, 300, 160), (64, 100, 512), (90, 77, 36)])
def test_flash_attention_reads_nothing_past_the_keys(cuda, tq, tk, d):
    """K and V are contiguous slices of buffers that hold NaN beyond Tk: a
    kernel that reads past the ragged edge shows it."""
    rng = np.random.RandomState(tk + d)
    q = torch.from_numpy(rng.randn(1, 1, tq, d).astype(np.float32)).to(cuda)
    for dt, tol in DTYPES:
        bufs = []
        for _ in range(2):
            buf = torch.full((1, 1, tk + 160, d), float("nan"), dtype=dt, device=cuda)
            buf[:, :, :tk] = torch.from_numpy(rng.randn(1, 1, tk, d).astype(np.float32)).to(cuda)
            bufs.append(buf[:, :, :tk])
        assert all(b.is_contiguous() for b in bufs)
        _close(tfa.attention, tfa.reference_attention, (q.to(dt), *bufs), {}, tol)


def test_deform_attn(cuda):
    """The pixel decoder's shapes, with samples partly and wholly outside."""
    rng = np.random.RandomState(0)
    shapes = [(16, 16), (32, 32), (64, 64)]
    n = sum(a * b for a, b in shapes)
    value = torch.from_numpy(rng.randn(1, n, 8, 32).astype(np.float32)).to(cuda)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (1, n, 8, 3, 4, 2)).astype(np.float32)).to(cuda)
    aw = torch.softmax(torch.from_numpy(rng.randn(1, n, 8, 12).astype(np.float32)), -1)
    aw = aw.reshape(1, n, 8, 3, 4).to(cuda)
    assert tda.variant(value.bfloat16(), loc) == "vec_d32_l3p4"
    for dt, tol in DTYPES:
        _close(tda.ms_deform_attn, tda.ms_deform_attn_reference, (value.to(dt), shapes, loc, aw), {}, tol)


def _deform_case(rng, b, d, shapes, npts, heads=3, lq=53):
    n = sum(h * w for h, w in shapes)
    value = rng.randn(b, n, heads, d).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, lq, heads, len(shapes), npts, 2)).astype(np.float32)
    aw = rng.rand(b, lq, heads, len(shapes), npts).astype(np.float32)
    return value, loc, aw


@pytest.mark.parametrize("d,shapes,npts", [
    (8, [(6, 9), (3, 5)], 4), (32, [(16, 16), (8, 8), (4, 4), (2, 2)], 1),
    (64, [(12, 7)], 8), (36, [(5, 11), (9, 4)], 2), (32, [(7, 13)], 8), (128, [(6, 6), (3, 3)], 3),
])
def test_deform_attn_widths_levels_points(cuda, d, shapes, npts):
    """B = 2, head dims 8 / 32 / 64 / 128 on the vector kernel and 36 (off a
    power of two) on the scalar one, 1 to 4 levels, 1 to 8 points."""
    rng = np.random.RandomState(d + npts)
    value, loc, aw = (torch.from_numpy(a).to(cuda) for a in _deform_case(rng, 2, d, shapes, npts))
    want = "scalar_bf16" if d == 36 else f"vec_d{d}_any"
    assert tda.variant(value.bfloat16(), loc) == want
    for dt, tol in DTYPES:
        _close(tda.ms_deform_attn, tda.ms_deform_attn_reference, (value.to(dt), shapes, loc, aw), {}, tol)


@pytest.mark.parametrize("d", [8, 32])
def test_deform_attn_edges_and_nothing_past_the_levels(cuda, d):
    """Locations on every side beyond [0, 1], exactly on 0 and 1, and exactly
    where a corner reaches -1 or the map's size (the sample is kept at -1 and
    dropped at size), with value a contiguous view of a buffer that holds
    NaN past the last level: a gather past the levels would show."""
    rng = np.random.RandomState(d)
    shapes = [(8, 8), (4, 6), (2, 2)]
    n, heads, lq, npts = sum(h * w for h, w in shapes), 2, 40, 4
    edge = []
    for h, w in shapes:
        edge.append([0.0, 1.0, -0.5 / w, (w + 0.5) / w, -0.5 / w + 1e-3, -0.7, 1.6, 0.5])
    loc = rng.uniform(-0.4, 1.4, (1, lq, heads, len(shapes), npts, 2)).astype(np.float32)
    for li in range(len(shapes)):
        vals = np.array(edge[li], np.float32)
        loc[0, :, :, li, :, 0] = rng.choice(vals, (lq, heads, npts))
        loc[0, :, :, li, :, 1] = rng.choice(vals * shapes[li][1] / shapes[li][0], (lq, heads, npts))
    aw = rng.rand(1, lq, heads, len(shapes), npts).astype(np.float32)
    loc, aw = torch.from_numpy(loc).to(cuda), torch.from_numpy(aw).to(cuda)
    for dt, tol in DTYPES:
        numel = n * heads * d
        buf = torch.full((numel + 64 * heads * d,), float("nan"), dtype=dt, device=cuda)
        buf[:numel] = torch.from_numpy(rng.randn(numel).astype(np.float32)).to(cuda)
        value = buf[:numel].view(1, n, heads, d)
        assert value.is_contiguous()
        got = tda.ms_deform_attn(value, shapes, loc, aw)
        assert torch.isfinite(got.float()).all()
        _close(tda.ms_deform_attn, tda.ms_deform_attn_reference, (value, shapes, loc, aw), {}, tol)


@pytest.mark.parametrize("c,cout,h,w", [(16, 16, 13, 21), (48, 48, 9, 35), (128, 128, 24, 40),
                                       (256, 512, 17, 19), (32, 7, 8, 16)])
def test_gn_silu_conv(cuda, c, cout, h, w):
    """B = 2 (per-batch statistics), maps that are not a multiple of the
    8 x 16 tile, channel counts off the 32-channel chunk and the 128-channel
    output tile; the border rows and columns held as strictly as the rest."""
    rng = np.random.RandomState(c + cout + h)
    x = torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32) * 2 + 0.5).to(cuda)
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1).to(cuda)
    wt = torch.from_numpy(rng.randn(3, 3, c, cout).astype(np.float32) * 0.05).to(cuda)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.1).to(cuda)
    groups = gn_groups(c)
    for dt, tol in DTYPES:
        _close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference,
               (x.to(dt), scale, bias, wt, b, groups), {}, tol)


def _gn_args(rng, bsz, h, w, c, cout, cuda, loc=0.5, spread=2.0):
    x = torch.from_numpy(rng.randn(bsz, h, w, c).astype(np.float32) * spread + loc).to(cuda)
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1).to(cuda)
    wt = torch.from_numpy(rng.randn(3, 3, c, cout).astype(np.float32) * (0.5 / np.sqrt(9 * c))).to(cuda)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.1).to(cuda)
    return x, scale, bias, wt, b


@pytest.mark.parametrize("bsz,c,cout,h,w,variant", [
    (1, 128, 128, 40, 48, "wgmma_n64"), (1, 128, 256, 40, 48, "wgmma_n64"),
    (1, 256, 512, 40, 48, "wgmma_n64"), (1, 512, 512, 40, 48, "wgmma_n64"),
    (2, 128, 128, 136, 130, "wgmma_n128"), (1, 512, 512, 64, 64, "wgmma_n64"),
    (1, 256, 512, 128, 128, "wgmma_n128"), (1, 72, 200, 9, 70, "wgmma_n64"),
    (2, 20, 24, 11, 67, "wgmma_n64"),
])
def test_gn_silu_conv_path_widths_and_variants(cuda, bsz, c, cout, h, w, variant):
    """The VAE's channel pairs at a reduced 40 x 48 map, both block widths
    of the tensor-core conv (128 output channels where the grid fills the
    card, 64 at the deep levels) with ragged row and column tiles, C off the
    64-channel chunk (72), C_out off the 128-channel tile (200, 24) and C off
    the 8-channel copy (20: plain-load staging)."""
    rng = np.random.RandomState(c + cout + h + w)
    x, scale, bias, wt, b = _gn_args(rng, bsz, h, w, c, cout, cuda)
    assert tgc.variant(x.bfloat16(), wt) == variant
    assert tgc.variant(x, wt) == "fma_fp32"
    for dt, tol in DTYPES:
        _close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference,
               (x.to(dt), scale, bias, wt, b, gn_groups(c)), {}, tol)


@pytest.mark.parametrize("c,cout,hw", [(512, 256, 256), (256, 256, 256), (256, 128, 512),
                                       (128, 128, 512)])
def test_gn_silu_conv_at_the_vae_decoders_full_levels(cuda, c, cout, hw):
    """The VAE decoder's 256^2 and 512^2 levels, which only the sampler's
    full decode runs (up to 128 MiB of bf16 input a call): the tensor-core
    conv with 128 output channels a block, against the plain version."""
    rng = np.random.RandomState(c + cout + hw)
    x, scale, bias, wt, b = _gn_args(rng, 1, hw, hw, c, cout, cuda)
    assert tgc.variant(x.bfloat16(), wt) == "wgmma_n128"
    for dt, tol in DTYPES:
        _close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference,
               (x.to(dt), scale, bias, wt, b, gn_groups(c)), {}, tol)


def test_gn_silu_conv_batches_with_different_statistics(cuda):
    """B = 2 whose batches differ by 40x in spread and by a mean of -20, and
    groups of mean 30 and spread 0.5; the bf16 x is also read through a view
    off 16 bytes (plain-load staging and scalar statistics)."""
    rng = np.random.RandomState(11)
    x, scale, bias, wt, b = _gn_args(rng, 2, 24, 70, 128, 128, cuda)
    x[0] = x[0] * 0.1
    x[1] = x[1] * 4.0 - 20.0
    x[:, :, :, 64:] = 30.0 + 0.5 * torch.randn_like(x[:, :, :, 64:])
    for dt, tol in DTYPES:
        args = (x.to(dt), scale, bias, wt, b, 32)
        _close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference, args, {}, tol)
        if dt == torch.bfloat16:
            buf = torch.empty(x.numel() + 1, dtype=dt, device=cuda)
            buf[1:] = args[0].reshape(-1)
            off = buf[1:].view(x.shape)
            assert off.data_ptr() % 16 and off.is_contiguous()
            _close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference, (off, *args[1:]), {}, tol)


def _stats_against_float64(x, scale, bias, groups):
    bsz, h, w, c = x.shape
    n = tgc.group_affine.launches
    a, s = tgc.group_affine(x, scale, bias, groups, 1e-6)
    torch.cuda.synchronize()
    assert tgc.group_affine.launches == n + 1
    xd = x.double().reshape(bsz, h * w, groups, c // groups)
    var, mean = torch.var_mean(xd, dim=(1, 3), correction=0)
    a64 = torch.rsqrt(var + 1e-6)[..., None] * scale.double().reshape(groups, -1)
    s64 = bias.double().reshape(groups, -1) - mean[..., None] * a64
    a64, s64 = a64.reshape(bsz, c), s64.reshape(bsz, c)
    assert float((a.double() - a64).abs().max()) <= 1e-5 * float(a64.abs().max())
    assert float((s.double() - s64).abs().max()) <= 1e-5 * float(s64.abs().max())


@pytest.mark.parametrize("loc,spread,bsz,h,w,c", [
    (30.0, 0.5, 2, 40, 48, 128), (0.0, 1.0, 1, 64, 64, 512), (30.0, 0.5, 1, 128, 128, 256),
    (-3.0, 5.0, 2, 9, 13, 20),
])
def test_group_statistics_kernel_against_float64(cuda, loc, spread, bsz, h, w, c):
    """The statistics kernels alone against float64 `var_mean` of the same
    values (bf16 and fp32 x): a within 1e-5 of max |a|, s within 1e-5 of
    max |s|, at a large mean over a small spread as well as at unit scale."""
    rng = np.random.RandomState(int(loc) + c + h)
    x, scale, bias, _, _ = _gn_args(rng, bsz, h, w, c, 8, cuda, loc=loc, spread=spread)
    for dt in (torch.bfloat16, torch.float32):
        _stats_against_float64(x.to(dt), scale, bias, gn_groups(c))


@pytest.mark.parametrize("bsz,c,cout,h,w,loc", [
    (1, 128, 128, 64, 96, 0.5), (1, 512, 512, 32, 64, 0.5), (2, 256, 256, 48, 40, 30.0),
    (1, 20, 24, 12, 67, -3.0),
])
def test_k4_on_row_bands_against_the_plain_band_version(cuda, bsz, c, cout, h, w, loc):
    """K4 as a banded VAE resblock runs it, two bands of a map: each band's
    moments from the statistics kernel, merged in rank order, give the
    whole map's affine (float64 `var_mean`, within 1e-5 of max |a|, |s|);
    the conv kernel on each band with one raw row of its neighbour against
    the plain band version on the same inputs (K4's tolerance), and the
    bands' rows against one K4 call on the whole map."""
    rng = np.random.RandomState(c + h + int(loc))
    x, scale, bias, wt, b = _gn_args(rng, bsz, h, w, c, cout, cuda, loc=loc,
                                     spread=0.5 if loc > 10 else 2.0)
    groups = gn_groups(c)
    for dt, tol in DTYPES:
        xd = x.to(dt)
        half = h // 2
        bands = [xd[:, :half].contiguous(), xd[:, half:].contiguous()]
        n = tgc.group_moments.launches
        moments = torch.stack([tgc.group_moments(band, groups) for band in bands])
        torch.cuda.synchronize()
        assert tgc.group_moments.launches == n + 2
        for band, mom in zip(bands, moments):
            ref = tgc.moments_reference(band, groups)
            assert torch.equal(mom[..., 0], ref[..., 0])
            assert float((mom[..., 1] - ref[..., 1]).abs().max()) <= 1e-6 * (1 + abs(loc))
            assert float(((mom[..., 2] - ref[..., 2]) / ref[..., 2]).abs().max()) <= 1e-5
        a, s = tgc.affine_from_moments(moments, scale, bias)
        v64, m64 = torch.var_mean(xd.double().reshape(bsz, h * w, groups, -1), dim=(1, 3),
                                  correction=0)
        a64 = torch.rsqrt(v64 + 1e-6)[..., None] * scale.double().reshape(groups, -1)
        s64 = bias.double().reshape(groups, -1) - m64[..., None] * a64
        assert float((a.double() - a64.reshape(bsz, c)).abs().max()) <= 1e-5 * float(a64.abs().max())
        assert float((s.double() - s64.reshape(bsz, c)).abs().max()) <= 1e-5 * float(s64.abs().max())
        exts = [xd[:, :half + 1].contiguous(), xd[:, half - 1:].contiguous()]
        for ext in exts:
            _close(tgc.affine_silu_conv, tgc.affine_silu_conv_reference, (ext, a, s, wt, b), {},
                   tol)
        rows = [tgc.affine_silu_conv(exts[0], a, s, wt, b)[:, :half],
                tgc.affine_silu_conv(exts[1], a, s, wt, b)[:, 1:]]
        whole = tgc.gn_silu_conv(xd, scale, bias, wt, b, groups).float()
        err = float((torch.cat(rows, 1).float() - whole).abs().max())
        assert err <= tol * max(1.0, float(whole.abs().max())), err


def test_k4_band_pieces_backward(cuda):
    """The band pieces' autograd Functions against their plain versions'
    autograd on the card: the moments (in x) and the conv given its affine
    (in x, a, s, w and b)."""
    rng = np.random.RandomState(5)
    x, scale, bias, wt, b = _gn_args(rng, 1, 24, 40, 64, 64, cuda)
    a, s = tgc.affine_from_stats(x, scale, bias, 32, 1e-6)
    _backward_close(tgc.affine_silu_conv, tgc.affine_silu_conv_reference, (x, a, s, wt, b),
                    lambda fn, *t: fn(*t), 1e-5)
    xs = x.detach().clone().requires_grad_()
    ys = x.detach().clone().requires_grad_()
    ct = torch.randn(1, 32, 3, device=cuda, dtype=torch.float64)
    (tgc.group_moments(xs, 32)[..., 1:] * ct[..., 1:]).sum().backward()
    (tgc.moments_reference(ys, 32)[..., 1:] * ct[..., 1:]).sum().backward()
    err = float((xs.grad - ys.grad).abs().max())
    assert err <= 1e-5 * max(1.0, float(ys.grad.abs().max())), err


@pytest.mark.parametrize("dt,c,offset,groups", [
    (torch.bfloat16, 512, 1, 32), (torch.float32, 512, 1, 32), (torch.bfloat16, 260, 0, 4),
    (torch.float32, 1028, 3, 4),
])
def test_gn_silu_conv_wide_channels_on_scalar_statistics(cuda, dt, c, offset, groups):
    """Widths whose statistics take scalar loads: the VAE's 512 channels in
    a view off 16 bytes (bf16 and fp32), bf16 C = 260 (off 8 channels) and
    fp32 C = 1028 off 16 bytes; more channel slots than the statistics
    kernel has threads, so a thread takes several in turn. The statistics
    against float64 and the whole call against the plain version."""
    rng = np.random.RandomState(c + offset)
    x, scale, bias, wt, b = _gn_args(rng, 2, 12, 20, c, 64, cuda, loc=30.0, spread=0.5)
    x[1] = x[1] * 3.0 - 100.0
    buf = torch.empty(x.numel() + offset, dtype=dt, device=cuda)
    buf[offset:] = x.to(dt).reshape(-1)
    xv = buf[offset:].view(x.shape)
    assert xv.is_contiguous() and (xv.data_ptr() % 16 != 0) == (offset != 0)
    assert tgc.stats_plan(12 * 20, c, dt, xv.data_ptr() % 16 == 0)[2] == 1
    _stats_against_float64(xv, scale, bias, groups)
    tol = dict(DTYPES)[dt]
    _close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference, (xv, scale, bias, wt, b, groups), {}, tol)


@pytest.mark.parametrize("dt,c", [(torch.bfloat16, 4096), (torch.float32, 6400)])
def test_group_statistics_kernel_past_256_slots(cuda, dt, c):
    """16-byte loads with more slots a pixel row than threads (bf16 4096:
    512 slots), and a row's moments past 48 KB of shared memory (fp32 6400
    by scalar loads through a view off 16 bytes)."""
    rng = np.random.RandomState(c)
    x = torch.from_numpy(rng.randn(2, 5, 7, c).astype(np.float32) * 0.5 + 30.0).to(cuda)
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1).to(cuda)
    offset = 0 if dt == torch.bfloat16 else 1
    buf = torch.empty(x.numel() + offset, dtype=dt, device=cuda)
    buf[offset:] = x.to(dt).reshape(-1)
    xv = buf[offset:].view(x.shape)
    assert tgc.stats_plan(35, c, dt, xv.data_ptr() % 16 == 0)[2] == (8 if offset == 0 else 1)
    _stats_against_float64(xv, scale, bias, 32)


def test_fused_resnet_block_keeps_k4_params_until_the_weights_change(cuda):
    """A fused VAE resblock on the card makes K4's weight layout once per
    conv and makes it again when a weight changes; each time it matches the
    unfused block on the same weights."""
    from xmask3d_tpu_torch.models.vae import ResnetBlock

    torch.manual_seed(0)
    fused = ResnetBlock(32, 64, fused_gn=True).to(cuda)
    plain = ResnetBlock(32, 64).to(cuda)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 12, 20, 32, device=cuda)

    def run():
        n = tgc.gn_silu_conv.launches
        with torch.no_grad():
            got, want = fused(x), plain(x)
        assert tgc.gn_silu_conv.launches == n + 2
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
        return fused._k4_params["conv1"][1][0]

    first = run()
    assert set(fused._k4_params) == {"conv1", "conv2"}
    assert run() is first
    with torch.no_grad():
        for m in (fused, plain):
            m.conv1.weight.mul_(-0.5)
    assert run() is not first


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.attention(x.transpose(2, 3), x.transpose(2, 3), x.transpose(2, 3))
    with pytest.raises(TypeError):
        tfa.attention(x.half(), x.half(), x.half())
    feats = torch.zeros(1, 8, 4, device=cuda)
    kmap = torch.zeros(1, 27, 8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tsc.sparse_conv(feats, torch.zeros(27, 4, 4, device=cuda), kmap)
    value = torch.zeros(1, 4, 2, 32, device=cuda)
    loc = torch.zeros(1, 3, 2, 1, 1, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        tda.ms_deform_attn(value, [(2, 2)], loc, torch.zeros(1, 3, 2, 1, 1, device=cuda))
    x = torch.zeros(1, 8, 8, 32, device=cuda)
    w, v = torch.zeros(3, 3, 32, 16, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(TypeError):
        tgc.gn_silu_conv(x.half(), v, v, w, v[:16])
    with pytest.raises(ValueError, match="contiguous"):
        tgc.gn_silu_conv(x.transpose(1, 2), v, v, w, v[:16])
    with pytest.raises(ValueError, match="one device"):
        tgc.gn_silu_conv(x, v.cpu(), v, w, v[:16])
    wk, bf = tgc.kernel_params(w, v[:16], torch.float32)
    with pytest.raises(ValueError, match="kernel_params"):
        tgc.gn_silu_conv(x, v, v, w, v[:16], params=(wk.bfloat16(), bf))


# --------------------------------------------------------------------------
# the models' plain GroupNorm calls: K4's statistics and `gn_apply_kernel`
# --------------------------------------------------------------------------

# fp32 is held to 1e-4: the plain formula's one-pass fp32 variance and the
# kernel's fp64-merged moments part by more than the summation order
GN_DTYPES = ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7))


def _gn_norm_args(rng, shape, cuda, loc=1.0, spread=3.0, p_dtype=torch.float32):
    c = shape[-1]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * spread + loc).to(cuda)
    w = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(cuda, p_dtype)
    b = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1).to(cuda, p_dtype)
    return x, w, b


def _group_norm_close(x, w, b, groups, silu, tol):
    n = tgc.group_norm.launches
    got = tgc.group_norm(x, w, b, groups, 1e-6, silu)
    torch.cuda.synchronize()
    assert tgc.group_norm.launches == n + 1
    assert got.dtype == x.dtype and got.shape == x.shape and got.is_contiguous()
    ref = tgc.group_norm_reference(x, w, b, groups, 1e-6, silu).float()
    err = float((got.float() - ref).abs().max())
    assert err <= tol * max(1.0, float(ref.abs().max())), err


# the serving view's GroupNorm shapes (B, H, W, C): the VAE encoder's levels,
# the decoder's, the SD UNet's, the backbone's projections and the pixel
# decoder's 256-channel maps
GN_PATH_SHAPES = [(1, 512, 512, 128), (1, 256, 256, 256), (1, 128, 128, 512), (1, 64, 64, 512),
                  (1, 64, 64, 320), (1, 32, 32, 640), (1, 16, 16, 1280), (1, 8, 8, 2560),
                  (1, 8, 8, 1280), (1, 128, 128, 256), (1, 64, 64, 256), (1, 32, 32, 256),
                  (1, 16, 16, 256), (1, 128, 128, 128), (1, 16, 16, 512)]


@pytest.mark.parametrize("shape", GN_PATH_SHAPES)
def test_group_norm_at_the_serving_shapes(cuda, shape):
    """Kernel against the plain formula, bf16 and fp32, SiLU on and off."""
    rng = np.random.RandomState(sum(shape))
    x, w, b = _gn_norm_args(rng, shape, cuda)
    for dt, tol in GN_DTYPES:
        for silu in (False, True):
            _group_norm_close(x.to(dt), w, b, gn_groups(shape[-1]), silu, tol)


@pytest.mark.parametrize("shape,loc,spread,p_dtype", [
    ((2, 13, 21, 36), 1.0, 3.0, torch.float32),       # C off 8: scalar loads in bf16
    ((2, 9, 7, 20), -2.0, 4.0, torch.bfloat16),       # C off 8, bf16 parameters
    ((2, 1, 1, 32), 30.0, 0.05, torch.float32),       # a group of one value near 30
    ((3, 1, 2, 32), 30.0, 0.0, torch.float32),        # groups of equal values
    ((2, 5, 3, 7), 0.5, 2.0, torch.float32),          # seven groups of one channel
    ((2, 300, 320), 0.0, 1.0, torch.bfloat16),        # (B, N, C): any rank
    ((1, 6, 10, 4096), 0.0, 1.0, torch.float32),      # more 16-byte slots than threads
])
def test_group_norm_widths_and_values(cuda, shape, loc, spread, p_dtype):
    rng = np.random.RandomState(len(shape) + shape[-1])
    x, w, b = _gn_norm_args(rng, shape, cuda, loc, spread, p_dtype)
    for dt, tol in GN_DTYPES:
        for silu in (False, True):
            _group_norm_close(x.to(dt), w, b, gn_groups(shape[-1]), silu, tol)


def test_group_norm_at_a_large_mean_against_float64(cuda):
    """Groups of mean 30 and spread 0.5, where the plain formula's one-pass
    variance loses digits: the kernel against float64 of the same values."""
    rng = np.random.RandomState(3)
    x, w, b = _gn_norm_args(rng, (2, 40, 48, 128), cuda, loc=30.0, spread=0.5)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        xd = x.to(dt)
        got = tgc.group_norm(xd, w, b, 32).double()
        xg = xd.double().reshape(2, -1, 32, 4)
        var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
        ref = ((xg - mean) * torch.rsqrt(var + 1e-6) * w.double().reshape(32, 4)
               + b.double().reshape(32, 4)).reshape(x.shape)
        assert float((got - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))


def test_group_norm_off_16_bytes_and_non_contiguous(cuda):
    """x through a view off 16 bytes (scalar loads) against the plain
    formula; a non-contiguous x, and a CUDA x of another type, refused."""
    rng = np.random.RandomState(5)
    x, w, b = _gn_norm_args(rng, (2, 24, 70, 128), cuda)
    for dt, tol in GN_DTYPES:
        buf = torch.empty(x.numel() + 1, dtype=dt, device=cuda)
        buf[1:] = x.to(dt).reshape(-1)
        off = buf[1:].view(x.shape)
        assert off.data_ptr() % 16 and off.is_contiguous()
        _group_norm_close(off, w, b, 32, True, tol)
        with pytest.raises(ValueError, match="contiguous"):
            tgc.group_norm(x.to(dt).transpose(1, 2), w, b, 32)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="dtype"):
            tgc.group_norm(x.to(dt), w, b, 32)


def test_group_norm_module_routes_only_unrecorded_calls_to_the_kernel(cuda):
    """The module takes the kernel under `no_grad` and for frozen inputs,
    and the plain formula, with its gradients, where autograd records."""
    rng = np.random.RandomState(6)
    x, _, _ = _gn_norm_args(rng, (2, 16, 16, 64), cuda)
    gn = GroupNorm(64).to(cuda)
    n = tgc.group_norm.launches
    with torch.no_grad():
        gn(x, silu=True)
    assert tgc.group_norm.launches == n + 1
    xg = x.clone().requires_grad_()
    y = gn(xg, silu=True)
    assert tgc.group_norm.launches == n + 1 and y.grad_fn is not None
    y.sum().backward()
    assert xg.grad is not None and gn.weight.grad is not None
    gn.requires_grad_(False)
    gn(x)
    assert tgc.group_norm.launches == n + 2


def test_group_norm_captured_and_replayed_equals_eager(cuda):
    """One bf16 call with SiLU captured into a CUDA graph and replayed equals
    the eager call bit for bit, before and after new values are copied into
    the input buffer; the counter counts the capture, not the replays."""
    rng = np.random.RandomState(7)
    x, w, b = _gn_norm_args(rng, (1, 64, 64, 320), cuda)
    x = x.bfloat16()
    eager = tgc.group_norm(x, w, b, 32, silu=True)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tgc.group_norm(static, w, b, 32, silu=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = tgc.group_norm.launches
    with torch.cuda.graph(graph):
        out = tgc.group_norm(static, w, b, 32, silu=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    new = (torch.randn_like(x.float()) * 0.5 - 2.0).bfloat16()
    static.copy_(new)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tgc.group_norm(new, w, b, 32, silu=True))
    assert tgc.group_norm.launches == n + 2  # the capture and the last eager call


# --------------------------------------------------------------------------
# backward: each wrapper's autograd Function against its plain version's
# autograd on the same CUDA inputs (the Function's backward recomputes that
# version, so the two differ only by the order of atomic adds)
# --------------------------------------------------------------------------


def _noncontig(t):
    """`t` as a non-contiguous view with the same values."""
    wide = torch.zeros(t.shape[:-1] + (2 * t.shape[-1],), dtype=t.dtype, device=t.device)
    wide[..., ::2] = t
    view = wide[..., ::2]
    assert not view.is_contiguous()
    return view


def _backward_close(fn, plain, diff, call, tol, seed=0):
    """Gradients of call(fn, *diff) and call(plain, *diff) for every tensor
    of `diff` under one seeded, non-contiguous cotangent; the kernel runs
    once in the forward and not at all in the backward."""
    xs = [x.detach().clone().requires_grad_() for x in diff]
    ys = [x.detach().clone().requires_grad_() for x in diff]
    n = fn.launches
    out = call(fn, *xs)
    assert fn.launches == n + 1 and out.grad_fn is not None
    gen = torch.Generator(device=out.device).manual_seed(seed)
    ct = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    out.backward(_noncontig(ct))
    assert fn.launches == n + 1
    call(plain, *ys).backward(ct)
    for i, (x, y) in enumerate(zip(xs, ys)):
        got, ref = x.grad.float(), y.grad.float()
        assert torch.isfinite(got).all(), i
        err = float((got - ref).abs().max())
        assert err <= tol * max(1.0, float(ref.abs().max())), (i, err)


@pytest.mark.parametrize("kernel,cin,cout", [(3, 96, 128), (5, 3, 64)])
def test_sparse_conv_backward(cuda, kernel, cin, cout):
    """B = 2, with bias and out_valid: feats, weights and bias."""
    rng = np.random.RandomState(11)
    hs = [tsc.build_hierarchy(np.unique(rng.randint(0, 24, size=(3000, 3)).astype(np.int32),
                                        axis=0), (4096, 2048, 1024, 512, 256)) for _ in range(2)]
    h = tsc.stack_hierarchies(hs, cuda)
    kmap = h.kmap5 if kernel == 5 else h.levels[0].kmap3
    valid = h.levels[0].valid
    feats = torch.from_numpy(rng.randn(2, 4096, cin).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(kmap.shape[1], cin, cout) / 8).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    for dt, tol in DTYPES:
        _backward_close(
            tsc.sparse_conv, tsc.sparse_conv_reference, (feats.to(dt), w.to(dt), bias.to(dt)),
            lambda f, x, wt, b: f(x, wt, kmap, bias=b, out_valid=valid), tol)


# the model's shape classes of K1's gather-form backward: level 0's k3 convs
# (C_out 96 takes the 96-wide weight-gradient tile), odd widths (scalar
# staging on both operands), the fused k5 stem (weights only: the colours
# take no gradient; packed (tap, channel) rows), a down conv through its
# transposed map, and a deep 256 -> 256 level with few live rows
K1_BACKWARD = [("kmap3", 96, 128), ("kmap3", 128, 96), ("kmap3", 13, 7), ("stem", 3, 64),
               ("down", 32, 32), ("deep", 256, 256)]


@pytest.mark.parametrize("kind,cin,cout", K1_BACKWARD)
def test_sparse_conv_gather_backward(cuda, kind, cin, cout):
    """A call with its map's transpose, B = 2, with bias and out_valid: its
    backward launches `k1_dgrad_*` / `k1_wgrad_*` in bf16 (the plain
    statement of the gather form in fp32), nothing through the wrapper, and
    gives the same gradients on a second run bit for bit. They are held to
    the plain version's VJP on the same values in fp32 (the plain VJP in
    bf16 rounds each tap's feature gradient; the kernels round once)."""
    rng = np.random.RandomState(cin + cout)
    caps = (4096, 2048, 1024, 512, 256)
    hs = [tsc.build_hierarchy(np.unique(rng.randint(0, 24, size=(3000, 3)).astype(np.int32),
                                        axis=0), caps) for _ in range(2)]
    h = tsc.stack_hierarchies(hs, cuda)
    lv = h.levels
    kmap, transpose, v_in, valid = {
        "kmap3": (lv[0].kmap3, tsc.SAME_LEVEL, caps[0], lv[0].valid),
        "stem": (h.kmap5, tsc.SAME_LEVEL, caps[0], lv[0].valid),
        "down": (h.down[0], tsc.down_transposes(h)[0], caps[0], lv[1].valid),
        "deep": (lv[3].kmap3, tsc.SAME_LEVEL, caps[3], lv[3].valid)}[kind]
    feats = torch.from_numpy(rng.randn(2, v_in, cin).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(kmap.shape[1], cin, cout) / 8).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    ct = torch.from_numpy(rng.randn(2, kmap.shape[2], cout).astype(np.float32)).to(cuda)
    need = (kind != "stem", True, True)
    for dt, tol in DTYPES:
        runs = []
        for _ in range(2):
            xs = [x.to(dt).clone().requires_grad_(n) for x, n in zip((feats, w, bias), need)]
            n, before = tsc.sparse_conv.launches, dict(tsc.sparse_conv.backward_calls)
            out = tsc.sparse_conv(xs[0], xs[1], kmap, bias=xs[2], out_valid=valid,
                                  transpose=transpose)
            out.backward(_noncontig(ct.to(dt)))
            torch.cuda.synchronize()
            assert tsc.sparse_conv.launches == n + 1
            assert tsc.sparse_conv.backward_calls == {"kernel": before["kernel"] + 1,
                                                      "plain": before["plain"]}
            runs.append([x.grad for x, n in zip(xs, need) if n])
        assert all(torch.equal(a, b) for a, b in zip(*runs)), "not deterministic"
        ys = [x.to(dt).float().clone().requires_grad_(n) for x, n in zip((feats, w, bias), need)]
        tsc.sparse_conv_reference(ys[0], ys[1], kmap, ys[2], valid).backward(ct.to(dt).float())
        for i, (got, y) in enumerate(zip(runs[0], [y for y, n in zip(ys, need) if n])):
            assert got.dtype == dt and torch.isfinite(got.float()).all(), i
            err = float((got.float() - y.grad).abs().max())
            assert err <= tol * max(1.0, float(y.grad.abs().max())), (dt, i, err)
        torch.cuda.empty_cache()


@pytest.mark.parametrize("tq,tk,d,h", [(4096, 4096, 40, 8), (4096, 77, 40, 8)])
def test_flash_attention_backward(cuda, tq, tk, d, h):
    """The SD UNet's self-attention (d 40 x 4096 keys) and its 77-key
    cross-attention, B = 2: q, k and v (bf16 through the kernels' backward,
    fp32 the plain VJP)."""
    rng = np.random.RandomState(tk)
    q, k, v = (torch.from_numpy(rng.randn(2, h, t, d).astype(np.float32)).to(cuda)
               for t in (tq, tk, tk))
    for dt, tol in DTYPES:
        _backward_close(tfa.attention, tfa.reference_attention, (q.to(dt), k.to(dt), v.to(dt)),
                        lambda f, *a: f(*a), tol)
        torch.cuda.empty_cache()


# K2's kernel backward (`attn_bwd_*`) at the SD UNet's self-attention of each
# head dim (8 heads), its 77-key cross-attention, activation sharding's band
# (half the queries against every key), tensor parallelism's (2, 4, T, d)
# half of the heads, and an odd head dim (scalar staging)
K2_BACKWARD = [(1, 8, 4096, 4096, 40), (1, 8, 1024, 1024, 80), (1, 8, 256, 256, 160),
               (1, 8, 4096, 77, 40), (1, 8, 2048, 4096, 40), (2, 4, 4096, 4096, 40),
               (2, 4, 1024, 77, 80), (1, 2, 100, 130, 36)]


@pytest.mark.parametrize("b,h,tq,tk,d", K2_BACKWARD)
def test_flash_attention_kernel_backward(cuda, b, h, tq, tk, d):
    """A recorded bf16 call's backward on the kernels, dO handed over as
    autograd does (the heads' transpose of a (B, T, H, d) gradient): each
    gradient within 2^-7 of max(1, max |plain|) of the fp32 plain VJP from
    the same bf16 values and of the kernels' own contract
    (`attention_backward_reference` on their lse); two runs
    equal bit for bit; no (Tq, Tk) buffer (under 100 MB above the
    backward's entry); counted as a kernel backward, launching nothing
    through the wrapper."""
    rng = np.random.RandomState(tq + tk + d)
    q, k, v = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(cuda).bfloat16()
               for t in (tq, tk, tk))
    do = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32)).to(cuda).bfloat16()
    do = do.transpose(1, 2)
    assert tfa.backward_plan(q.dtype, d)
    runs = []
    for _ in range(2):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        n, before = tfa.attention.launches, dict(tfa.attention.backward_calls)
        out = tfa.attention(*xs)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs.append(torch.autograd.grad(out, xs, do))
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < 100 * 2 ** 20
        assert tfa.attention.launches == n + 1
        assert tfa.attention.backward_calls == {"kernel": before["kernel"] + 1,
                                                "plain": before["plain"]}
    assert all(torch.equal(a, c) for a, c in zip(*runs)), "not deterministic"
    ys = [x.float().clone().requires_grad_() for x in (q, k, v)]
    tfa.reference_attention(*ys).backward(do.float())
    _, lse = tfa._launch(q, k, v, with_lse=True)
    contract = tfa.attention_backward_reference(q, k, v, lse, do)
    tol = 2.0 ** -7
    for i, (got, y, c) in enumerate(zip(runs[0], ys, contract)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all(), i
        for ref in (y.grad, c):
            err = float((got.float() - ref).abs().max())
            assert err <= tol * max(1.0, float(ref.abs().max())), (i, err)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("tq,tk,d,h", [(4096, 4096, 40, 8), (1024, 77, 80, 8), (256, 256, 160, 8),
                                       (64, 64, 160, 8), (100, 130, 36, 2), (70, 77, 20, 3)])
def test_flash_attention_lse_and_output_bits(cuda, tq, tk, d, h):
    """The forward a recorded call runs writes each row's log-sum-exp within
    1e-5 of max(1, |lse|) of the fp32 statement's, and an output equal bit
    for bit to the forward without lse, which a call under no_grad runs."""
    rng = np.random.RandomState(tq + d)
    q, k, v = (torch.from_numpy(rng.randn(2, h, t, d).astype(np.float32)).to(cuda).bfloat16()
               for t in (tq, tk, tk))
    o_lse, lse = tfa._launch(q, k, v, with_lse=True)
    o, none = tfa._launch(q, k, v)
    assert none is None
    with torch.no_grad():
        o_nograd = tfa.attention(q.requires_grad_(), k, v)
    assert torch.equal(o_lse, o) and torch.equal(o_nograd, o)
    _, want = tfa.reference_attention_lse(q.detach(), k, v)
    assert lse.shape == (2, h, tq) and lse.dtype == torch.float32
    err = float((lse - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


def test_flash_attention_plain_backward_routes_on_the_card(cuda):
    """fp32 calls and the VAE's 512-wide head keep the plain VJP: counted
    as plain, gradients as the plain version's autograd."""
    rng = np.random.RandomState(21)
    for dt, h, t, d in ((torch.float32, 2, 256, 40), (torch.bfloat16, 1, 256, 512)):
        q, k, v = (torch.from_numpy(rng.randn(1, h, t, d).astype(np.float32)).to(cuda).to(dt)
                   for _ in range(3))
        before = dict(tfa.attention.backward_calls)
        _backward_close(tfa.attention, tfa.reference_attention, (q, k, v), lambda f, *a: f(*a),
                        dict(DTYPES)[dt])
        assert tfa.attention.backward_calls == {"kernel": before["kernel"],
                                                "plain": before["plain"] + 1}


def test_deform_attn_backward(cuda):
    """The pixel decoder's shape at B = 2, samples partly outside the maps:
    value, locations and weights."""
    rng = np.random.RandomState(12)
    shapes = [(64, 64), (32, 32), (16, 16)]
    n = sum(a * b for a, b in shapes)
    value = torch.from_numpy(rng.randn(2, n, 8, 32).astype(np.float32)).to(cuda)
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 5376, 8, 3, 4, 2)).astype(np.float32)).to(cuda)
    aw = torch.from_numpy(rng.rand(2, 5376, 8, 3, 4).astype(np.float32)).to(cuda)
    for dt, tol in DTYPES:
        _backward_close(tda.ms_deform_attn, tda.ms_deform_attn_reference, (value.to(dt), loc, aw),
                        lambda f, v, l, a: f(v, shapes, l, a), tol)


def test_gn_silu_conv_backward(cuda):
    """A VAE stage's widths at B = 2: x, the norm's scale and bias, the conv
    weight and bias."""
    rng = np.random.RandomState(13)
    c = cout = 128
    x = torch.from_numpy(rng.randn(2, 32, 40, c).astype(np.float32)).to(cuda)
    scale = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(3, 3, c, cout) / 30).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    for dt, tol in DTYPES:
        _backward_close(tgc.gn_silu_conv, tgc.gn_silu_conv_reference,
                        (x.to(dt), scale, bias, w, b), lambda f, *a: f(*a, groups=32), tol)


def test_tiny_training_step_on_the_card(cuda):
    """One fp32 training step of the tiny model on the card: every loss
    finite, K1-K3 launched in the forward (and K2 again in the backward,
    where remat recomputes the UNet's blocks), a finite
    non-zero gradient for both 3D UNets and the other trainable group, none
    for a frozen parameter, and the optimizer moving the parameters."""
    import os

    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model, label_tree
    from xmask3d_tpu_torch.engine.train_step import (
        create_train_state, make_optimizer, make_train_step)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs/scannet/xmask3d_scannet_B15N4.yaml"))
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32", dec_layers=2, pixel_enc_layers=2)
    model = build_train_model(cfg, tiny=True, device=cuda)
    statics = build_statics(model, cfg, device=cuda)
    batch = synthetic_batch(2, Capacities(512, 256, 8), seed=0, num_points=400,
                            image_size=(128, 128), mask_shape=(24, 32), context_length=16,
                            vocab_size=512, device=cuda)
    batch["binary_label_3d"][0] = 0.0  # one all-novel and one all-base view: contra is live
    batch["binary_label_3d"][1] = 1.0
    state = create_train_state(model, make_optimizer(model, 1e-3, 1e-4, 10))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kernels = (tsc.sparse_conv, tfa.attention, tda.ms_deform_attn)
    counts = [k.launches for k in kernels]
    grads = {}
    real_step = state.optimizer.step

    def keep_grads(step):
        for n, p in model.named_parameters():
            grads[n] = None if p.grad is None else p.grad.detach().clone()
        real_step(step)

    state.optimizer.step = keep_grads
    metrics = make_train_step(dict(cfg.loss_weight))(state, batch, statics, 1.0)
    assert all(k.launches > c for k, c in zip(kernels, counts))
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    labels = label_tree(model)
    for prefix in ("pc_decoder.", "pc_binary_head.", "mask_decoder."):
        g = [grads[n] for n in grads if n.startswith(prefix) and grads[n] is not None]
        norm = float(torch.linalg.vector_norm(torch.stack([x.norm() for x in g])))
        assert g and np.isfinite(norm) and norm > 0, prefix
    assert all(grads[n] is None for n in grads if labels[n] == "frozen")
    moved = [n for n, p in model.named_parameters() if labels[n] != "frozen"
             and not torch.equal(p, before[n])]
    assert moved and all(torch.equal(p, before[n]) for n, p in model.named_parameters()
                         if labels[n] == "frozen")


# --------------------------------------------------------------------------
# CUDA graphs: kernels launched through ctypes inside a capture
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,rows", [(96, 128, 4096), (256, 256, 256)])
def test_sparse_conv_captured_and_replayed_equals_eager(cuda, cin, cout, rows):
    """One bf16 K1 call captured into a CUDA graph and replayed equals the
    eager call bit for bit, before and after new values are copied into the
    graph's input buffers: the launch, its scratch (the split-K partial
    sums of the deep level's variant) and its stream come from the capture,
    and no pointer is kept from one call to the next. The counter counts the
    capture, not the replays."""
    rng = np.random.RandomState(cin)
    coords = np.unique(rng.randint(0, 24, size=(3000, 3)).astype(np.int32), axis=0)
    h = tsc.build_hierarchy(coords, (rows, rows // 2, rows // 4, rows // 8, rows // 16))
    kmap = torch.from_numpy(h.kmap3[0][None]).to(cuda)
    valid = torch.from_numpy(h.valid[0][None]).to(cuda)
    feats = torch.from_numpy(rng.randn(1, rows, cin).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(27, cin, cout) / 30).astype(np.float32)).to(
        cuda, torch.bfloat16)
    eager = tsc.sparse_conv(feats, w, kmap, out_valid=valid)
    static = feats.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsc.sparse_conv(static, w, kmap, out_valid=valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = tsc.sparse_conv.launches
    with torch.cuda.graph(graph):
        out = tsc.sparse_conv(static, w, kmap, out_valid=valid)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    new = torch.randn_like(feats)
    static.copy_(new)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tsc.sparse_conv(new, w, kmap, out_valid=valid))
    assert tsc.sparse_conv.launches == n + 2  # the capture and the last eager call


def _tiny_serving(cuda, dtype):
    import os

    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.engine.builder import build_model, build_statics

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs/scannet/xmask3d_scannet_B15N4.yaml"))
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype=dtype, max_points=512, max_voxels=256, max_targets=8)
    model = build_model(cfg, tiny=True, seed=1, device=cuda, fused_gn=True)
    return cfg, model, build_statics(model, cfg, device=cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_view_equals_eager(cuda, dtype):
    """The tiny model's view through `make_infer_step` (one CUDA graph,
    K1-K4 inside it) equals its eager body on two views, which replay the
    same graph: exact on the routed labels, within 1e-5 (fp32) or 2^-7
    (bf16) relative on the features."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.infer_cli import make_infer_step

    cfg, model, statics = _tiny_serving(cuda, dtype)
    step, _ = make_infer_step(model, cfg)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for seed in (3, 4):
        batch = synthetic_batch(1, Capacities(512, 256, 8), seed=seed, num_points=400,
                                image_size=(64, 64), mask_shape=(24, 32), context_length=16,
                                vocab_size=512, device=cuda)
        got = {k: v.clone() for k, v in step(batch, statics).items()}
        want = step.fn(batch, statics)
        torch.cuda.synchronize()
        for k in ("pred", "pred_3d", "covered_2d", "binary_pred"):
            assert torch.equal(got[k], want[k]), k
        for k in ("feat_2d", "text"):
            err = float((got[k] - want[k]).abs().max())
            assert err <= tol * max(1.0, float(want[k].abs().max())), (k, err)
    assert step.graphs == 1


def test_scene_scan_equals_per_view_dispatch_on_the_card(cuda):
    """`make_scene_scan_step` (the captured view body replayed per view)
    leaves the same votes as the eager view body dispatched view by view,
    on a scene's stacked views with plumbed point ids."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_scene
    from xmask3d_tpu_torch.engine import serve

    cfg, model, statics = _tiny_serving(cuda, "bfloat16")
    caps = Capacities(512, 256, 8)
    scene = synthetic_scene(caps, seed=5, num_points=900, num_views=3, num_classes=cfg.classes,
                            image_size=(64, 64), mask_shape=(24, 32), context_length=16,
                            vocab_size=512)
    stacked, idxseq, n_pts = serve.stack_scene_views(scene, caps, cfg.classes, device=cuda)
    scan = serve.make_scene_scan_step(model, cfg, device=cuda)
    got = scan(stacked, idxseq, statics, *serve.fresh_vote_state(n_pts, 19, device=cuda))
    body = serve.make_view_body(model, cfg, device=cuda)
    want = serve.fresh_vote_state(n_pts, 19, device=cuda)
    for v in idxseq.tolist():
        want = body(_view_of(stacked, v), statics, *want)
    assert int(got[1].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert scan.step.graphs == 1


def _view_of(tree, v):
    from xmask3d_tpu_torch.engine.graphs import tree_map

    return tree_map(lambda t: t[v], tree)


# --------------------------------------------------------------------------
# the hierarchy built on the device, and prefetch beside a capture
# --------------------------------------------------------------------------


def test_device_hierarchy_on_the_card_equals_it_on_the_cpu(cuda):
    """`build_hierarchy_on_device` on the card gives the CPU's hierarchy bit
    for bit, level 0's maps equal the host builder's, and a CUDA graph of it
    replays to the same leaves on new coords."""
    from xmask3d_tpu_torch.engine.graphs import GraphStep, flatten
    from xmask3d_tpu_torch.ops.hierarchy_device import build_hierarchy_on_device

    caps = (1024, 512, 256, 128, 64)
    rng = np.random.RandomState(11)
    coords = np.zeros((2, caps[0], 3), np.int32)
    num = np.zeros((2,), np.int32)
    for b, hi in enumerate((24, 1024)):
        c = np.unique(rng.randint(0, hi, (900, 3)).astype(np.int32), axis=0)[: caps[0]]
        coords[b, : len(c)], num[b] = c, len(c)
    ct, nt = torch.from_numpy(coords), torch.from_numpy(num)
    want = flatten(build_hierarchy_on_device(ct, nt, caps))[1]
    got = flatten(build_hierarchy_on_device(ct.to(cuda), nt.to(cuda), caps))[1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    host = tsc.build_hierarchy(coords[0, : num[0]], caps)
    on_card = build_hierarchy_on_device(ct.to(cuda), nt.to(cuda), caps)
    assert np.array_equal(on_card.kmap5[0].cpu().numpy(), host.kmap5)
    assert np.array_equal(on_card.levels[0].kmap3[0].cpu().numpy(), host.kmap3[0])
    step = GraphStep(lambda c, n: build_hierarchy_on_device(c, n, caps), cuda)
    step(ct.to(cuda), nt.to(cuda))
    swapped = (ct.flip(0).to(cuda), nt.flip(0).to(cuda))
    replayed = [t.clone() for t in flatten(step(*swapped))[1]]
    for g, w in zip(replayed, flatten(build_hierarchy_on_device(*swapped, caps))[1]):
        assert torch.equal(g, w)
    assert step.graphs == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_view_on_a_device_hierarchy_equals_eager(cuda, dtype):
    """The tiny model's view with `device_hierarchy=True` (the hierarchy
    built inside the graph) through `make_infer_step` equals its eager body,
    as `test_captured_view_equals_eager` holds the host-built view, and
    equals the host-built view with its levels in sorted-key order
    (`to_key_order`) exactly on the labels; at capacities no level fills."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.infer_cli import make_infer_step
    from xmask3d_tpu_torch.ops.hierarchy_device import to_key_order

    cfg, model, statics = _tiny_serving(cuda, dtype)
    step, _ = make_infer_step(model, cfg)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    caps = Capacities(512, 4096, 8)
    kw = dict(num_points=400, image_size=(64, 64), mask_shape=(24, 32), context_length=16,
              vocab_size=512, device=cuda)
    for seed in (3, 4):
        batch = synthetic_batch(1, caps, seed=seed, device_hierarchy=True, **kw)
        assert "hierarchy" not in batch and batch["voxel_coords"].shape == (1, 4096, 3)
        host = synthetic_batch(1, caps, seed=seed, **kw)
        assert all(int(lv.num[0]) < c for lv, c in zip(host["hierarchy"].levels,
                                                        caps.level_caps()))
        got = {k: v.clone() for k, v in step(batch, statics).items()}
        want = step.fn(batch, statics)
        keyed = step.fn(dict(host, hierarchy=to_key_order(host["hierarchy"])), statics)
        torch.cuda.synchronize()
        for k in ("pred", "pred_3d", "covered_2d", "binary_pred"):
            assert torch.equal(got[k], want[k]), k
            assert torch.equal(got[k], keyed[k]), k
        for k in ("feat_2d", "text"):
            err = float((got[k] - want[k]).abs().max())
            assert err <= tol * max(1.0, float(want[k].abs().max())), (k, err)
    assert step.graphs == 1


def test_capture_while_prefetch_workers_build_batches(cuda):
    """Prefetch workers build CPU tensors and make no CUDA call, so a CUDA
    graph captured on the main thread while they run stays valid; the
    batches they built, pinned and copied in here, replay like eager."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.prefetch import parallel_map_iterator, to_device
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.infer_cli import make_infer_step

    cfg, model, statics = _tiny_serving(cuda, "bfloat16")
    caps = Capacities(512, 256, 8)
    kw = dict(num_points=400, image_size=(64, 64), mask_shape=(24, 32), context_length=16,
              vocab_size=512)
    built = parallel_map_iterator(lambda s: synthetic_batch(1, caps, seed=s, device="cpu", **kw),
                                  iter(range(20, 32)), workers=4)
    first = to_device(next(built), cuda)  # the pool is running from here on
    step, _ = make_infer_step(model, cfg)
    step(first, statics)  # warm-up and capture while the workers build
    for cpu_batch in built:
        batch = to_device(cpu_batch, cuda)
        got = {k: v.clone() for k, v in step(batch, statics).items()}
        want = step.fn(batch, statics)
        torch.cuda.synchronize()
        assert torch.equal(got["pred"], want["pred"])
    assert step.graphs == 1
