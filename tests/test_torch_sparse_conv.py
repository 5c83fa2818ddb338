"""Port's sparse conv (kernel K1's module) against the JAX package.

The port's host hierarchy builder must give bit-identical kernel maps to the
JAX builder; its plain sparse conv (the kernel's CPU version) must match both
the JAX XLA formulation and the Pallas kernel in interpret mode, within 1e-5
relative in fp32, over missing neighbours (-1), all-padding tiles, the k5
stem's 125 taps with C_in = 3, and widths that are not multiples of 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu.ops import sparse_conv as jsc
from xmask3d_tpu.ops.sparse_conv_pallas import sparse_conv_pallas_v2
from xmask3d_tpu_torch.ops import sparse_conv as tsc

CAPS = (384, 192, 96, 48, 24)


def _coords(seed, n=300, hi=16):
    rng = np.random.RandomState(seed)
    return np.unique(rng.randint(0, hi, size=(n, 3)).astype(np.int32), axis=0)


@pytest.mark.parametrize("seed,hi", [(0, 16), (1, 40)])
def test_hierarchy_maps_bit_identical(seed, hi):
    """JAX builder (native library when present, as the package runs it)
    against the port's numpy builder, leaf by leaf."""
    coords = _coords(seed, hi=hi)
    hj = jsc.build_hierarchy(coords, CAPS)
    ht = tsc.stack_hierarchies([tsc.build_hierarchy(coords, CAPS)], device="cpu")
    for lj, lt in zip(hj.levels, ht.levels):
        np.testing.assert_array_equal(np.asarray(lj.coords), lt.coords[0].numpy())
        np.testing.assert_array_equal(np.asarray(lj.valid), lt.valid[0].numpy())
        np.testing.assert_array_equal(np.asarray(lj.kmap3), lt.kmap3[0].numpy())
        assert int(lj.num) == int(lt.num[0])
    for name in ("down", "up_parent", "up_octant"):
        for a, b in zip(getattr(hj, name), getattr(ht, name)):
            np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    np.testing.assert_array_equal(np.asarray(hj.kmap5), ht.kmap5[0].numpy())
    assert ht.kmap5.dtype == torch.int32


def _case(seed, cin, cout, kernel, pad_tail=True):
    rng = np.random.RandomState(seed)
    coords = _coords(seed)
    h = jsc.build_hierarchy(coords, CAPS)
    kmap = np.asarray(h.kmap5 if kernel == 5 else h.levels[0].kmap3)[None]
    k = kmap.shape[1]
    feats = rng.randn(1, CAPS[0], cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    valid = np.zeros((1, CAPS[0]), bool)
    valid[0, : len(coords)] = True
    if pad_tail:
        feats[0, len(coords):] = 0.0
    return feats, w, kmap, bias, valid


@pytest.mark.parametrize("kernel,cin,cout", [(3, 8, 16), (5, 3, 64), (3, 13, 7)])
def test_plain_matches_jax(kernel, cin, cout):
    feats, w, kmap, bias, valid = _case(0, cin, cout, kernel)
    assert (kmap == -1).any()  # missing neighbours
    ref_xla = np.asarray(jsc.sparse_conv(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(kmap),
        bias=jnp.asarray(bias), out_valid=jnp.asarray(valid),
    ))
    ref_pallas = np.asarray(sparse_conv_pallas_v2(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(kmap),
        bias=jnp.asarray(bias), out_valid=jnp.asarray(valid), q_tile=128,
        interpret=True,
    ))
    out = tsc.sparse_conv(
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(kmap),
        bias=torch.from_numpy(bias), out_valid=torch.from_numpy(valid),
    ).numpy()
    scale = np.abs(ref_xla).max()
    np.testing.assert_allclose(out, ref_xla, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(out, ref_pallas, rtol=1e-5, atol=1e-5 * scale)
    # all-padding tiles (rows past the live voxels) come out zero
    assert not out[0, valid.sum():].any()


def test_down_conv_and_empty_output():
    """Stride-2 map (K = 8) into the next level, and a map with no hit."""
    coords = _coords(2)
    h = jsc.build_hierarchy(coords, CAPS)
    rng = np.random.RandomState(2)
    feats = rng.randn(1, CAPS[0], 16).astype(np.float32)
    w = rng.randn(8, 16, 24).astype(np.float32)
    kmap = np.asarray(h.down[0])[None]
    ref = np.asarray(jsc.sparse_conv(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(kmap)))
    out = tsc.sparse_conv(torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(kmap))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    empty = np.full_like(kmap, -1)
    out = tsc.sparse_conv(torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(empty))
    assert not out.numpy().any()


def test_transpose_and_global_max_pool():
    coords = _coords(3)
    h = jsc.build_hierarchy(coords, CAPS)
    rng = np.random.RandomState(3)
    coarse = rng.randn(1, CAPS[1], 12).astype(np.float32)
    w = rng.randn(8, 12, 10).astype(np.float32)
    parent = np.asarray(h.up_parent[0])[None]
    octant = np.asarray(h.up_octant[0])[None]
    ref = np.asarray(jsc.sparse_conv_transpose(
        jnp.asarray(coarse), jnp.asarray(w), jnp.asarray(parent), jnp.asarray(octant)))
    out = tsc.sparse_conv_transpose(
        torch.from_numpy(coarse), torch.from_numpy(w), torch.from_numpy(parent),
        torch.from_numpy(octant)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    valid = np.asarray(h.levels[1].valid)[None]
    ref = np.asarray(jsc.global_max_pool(jnp.asarray(coarse), jnp.asarray(valid)))
    out = tsc.global_max_pool(torch.from_numpy(coarse), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_wrapper_rejects_other_devices():
    x = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError):
        tsc.sparse_conv(x, torch.zeros(27, 3, 8, device="meta"),
                        torch.zeros(1, 27, 4, dtype=torch.int32, device="meta"))


# --------------------------------------------------------------------------
# which kernel a call takes on the card (`variant`, `kernel_plan`) and the
# (strip, tap) steps it walks
# --------------------------------------------------------------------------


def _full_width_conv_shapes():
    """(taps, C_in, C_out) of every sparse conv with a kernel map in the two
    full-width MinkUNets, plus their fused k5 stem."""
    from xmask3d_tpu_torch.models.minkunet import SparseConv, mink_unet

    shapes = {(125, 3, 64)}
    with torch.device("meta"):
        nets = [mink_unet(arch="MinkUNet34C"), mink_unet(arch="MinkUNet18A")]
    for net in nets:
        for mod in net.modules():
            if isinstance(mod, SparseConv) and mod.kernel.shape[0] in (8, 27):
                shapes.add(tuple(mod.kernel.shape))
    return sorted(shapes)


LEVEL_CAPS = (24576, 12288, 6144, 3072, 1536)


@pytest.mark.parametrize("k,c_in,c_out", _full_width_conv_shapes())
def test_variant_of_every_full_width_conv(k, c_in, c_out):
    """At every level's capacity: bf16 takes a tensor-core variant whose
    channel tiles cover C_out, gathers by 16-byte copies unless a width is off
    8 values (only the stem), and splits K only where the level cannot fill
    the card; fp32 takes the CUDA-core kernel."""
    assert c_in % 8 == 0 or (k, c_in) == (125, 3)
    for v_out in LEVEL_CAPS:
        name, nc, kc, packed, split = tsc.kernel_plan(torch.bfloat16, k, c_in, c_out, v_out)
        feats = torch.empty(1, v_out, c_in, dtype=torch.bfloat16, device="meta")
        w = torch.empty(k, c_in, c_out, dtype=torch.bfloat16, device="meta")
        kmap = torch.empty(1, k, v_out, dtype=torch.int32, device="meta")
        assert tsc.variant(feats, w, kmap) == name and name.startswith("mma_")
        assert nc in tsc.MMA_WIDTHS and kc in (32, 64)
        assert packed == (c_in % 8 != 0) and ("packed" in name) == packed
        full = min(w for w in tsc.MMA_WIDTHS if w >= c_out)
        tiles = -(-v_out // tsc.TILE_ROWS)
        # narrower than C_out only where twice the width would leave SMs idle
        assert nc == full or (64 <= nc < full and tiles * -(-c_out // (2 * nc)) < tsc.SM_COUNT)
        blocks = -(-v_out // tsc.TILE_ROWS) * -(-c_out // nc)
        units = -(-k * c_in // kc) if packed else k
        assert 1 <= split <= units
        assert (split == 1) == (blocks >= 2 * tsc.SM_COUNT or units == 1)
        assert (kc == 64) == (not packed and c_in % 64 == 0)
        assert tsc.variant(feats.float(), w.float(), kmap) == "fma_fp32"


def test_kernel_plan_of_odd_and_misaligned_inputs():
    assert tsc.kernel_plan(torch.bfloat16, 27, 13, 7, 4096)[:4] == ("mma_packed_n32_k32_s11", 32, 32, True)
    assert tsc.kernel_plan(torch.bfloat16, 27, 32, 64, 24576) == ("mma_gather_n64_k32", 64, 32, False, 1)
    # the same widths through a view off 16 bytes: packed mode, same tile
    assert tsc.kernel_plan(torch.bfloat16, 27, 32, 64, 24576, aligned=False) == \
        ("mma_packed_n64_k32", 64, 32, True, 1)
    # C_out beyond a block's 256 channels is tiled over the grid
    assert tsc.kernel_plan(torch.bfloat16, 27, 64, 640, 65536)[1] == 256


@pytest.mark.parametrize("seed,with_valid", [(0, True), (1, False), (2, True)])
def test_strip_tap_steps_against_numpy(seed, with_valid):
    """The (16-row strip, tap) steps of live 64-row tiles and those with a
    hit, counted by loops in numpy, rows past a ragged last tile included."""
    rng = np.random.RandomState(seed)
    b, k, v = 2, 8, 200  # 3 full tiles and a ragged one
    kmap = rng.randint(0, v, size=(b, k, v)).astype(np.int32)
    kmap[rng.rand(b, k, v) < 0.9] = -1
    kmap[:, :, 64:128] = -1
    valid = np.ones((b, v), bool)
    if with_valid:
        valid[:, 128:192] = False
        valid[0, 5] = False
    steps = hit = 0
    for i in range(b):
        for t0 in range(0, v, 64):
            if not valid[i, t0:t0 + 64].any():
                continue
            for s0 in range(t0, t0 + 64, 16):
                for tap in range(k):
                    steps += 1
                    rows = slice(s0, min(s0 + 16, v))
                    hit += bool(((kmap[i, tap, rows] >= 0) & valid[i, rows]).any())
    got = tsc.strip_tap_steps(torch.from_numpy(kmap),
                              torch.from_numpy(valid) if with_valid else None)
    assert got == (steps, hit) and 0 < hit < steps
