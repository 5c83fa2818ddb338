"""Port's deformable attention (kernel K3's module) against the JAX package.

The plain version (the kernel's CPU path) must match the JAX XLA
formulation and the Pallas kernel in interpret mode within 1e-5 relative in
fp32, with samples that fall partly or wholly outside the maps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu.ops.deform_attn import ms_deform_attn, ms_deform_attn_pallas
from xmask3d_tpu_torch.ops import deform_attn as tda


def _case(seed, b=2, heads=4, d=8, lq=37, npts=4, shapes=((6, 9), (3, 5)), lo=-0.3, hi=1.3):
    rng = np.random.RandomState(seed)
    n = sum(h * w for h, w in shapes)
    value = rng.randn(b, n, heads, d).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(b, lq, heads, len(shapes), npts, 2)).astype(np.float32)
    logits = rng.randn(b, lq, heads, len(shapes) * npts)
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, shapes, loc, aw.reshape(b, lq, heads, len(shapes), npts).astype(np.float32)


def _port(value, shapes, loc, aw):
    return tda.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                              torch.from_numpy(aw)).numpy()


@pytest.mark.parametrize("seed,d", [(0, 8), (1, 32)])
def test_plain_matches_pallas_and_xla(seed, d):
    value, shapes, loc, aw = _case(seed, d=d)
    args = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw))
    ref = np.asarray(ms_deform_attn(*args))
    pallas = np.asarray(ms_deform_attn_pallas(*args, q_tile=128, interpret=True))
    out = _port(value, shapes, loc, aw)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)


def test_samples_outside_contribute_zero():
    """Wholly outside [-1, size) in pixel units: zero; the one-pixel ring
    just outside still blends the edge row as grid_sample does."""
    value, shapes, loc, aw = _case(2, lo=1.5, hi=3.0)
    assert not _port(value, shapes, loc, aw).any()
    value, shapes, loc, aw = _case(3, lo=-0.1, hi=0.0)
    ref = np.asarray(ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw)))
    np.testing.assert_allclose(_port(value, shapes, loc, aw), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("dtype,d,levels,points,aligned,want", [
    (torch.bfloat16, 32, 3, 4, True, ("vec_d32_l3p4", 4, True)),
    (torch.bfloat16, 32, 4, 1, True, ("vec_d32_any", 4, False)),
    (torch.bfloat16, 8, 3, 4, True, ("vec_d8_any", 1, False)),
    (torch.bfloat16, 64, 1, 8, True, ("vec_d64_any", 8, False)),
    (torch.bfloat16, 256, 2, 2, True, ("vec_d256_any", 32, False)),
    (torch.bfloat16, 36, 3, 4, True, ("scalar_bf16", 0, False)),
    (torch.bfloat16, 48, 3, 4, True, ("scalar_bf16", 0, False)),
    (torch.bfloat16, 512, 3, 4, True, ("scalar_bf16", 0, False)),
    (torch.bfloat16, 32, 3, 4, False, ("scalar_bf16", 0, False)),
    (torch.float32, 32, 3, 4, True, ("scalar_fp32", 0, False)),
])
def test_kernel_plan(dtype, d, levels, points, aligned, want):
    """bf16 head dims of 8 times a power of two take the 16-byte-gather
    kernel with d / 8 lanes a value row, unrolled at the pixel decoder's
    d = 32 x 3 levels x 4 points; everything else the scalar kernel."""
    assert tda.kernel_plan(dtype, d, levels, points, aligned) == want
    value = torch.zeros(1, 4, 2, d, dtype=dtype)
    loc = torch.zeros(1, 3, 2, levels, points, 2)
    if aligned:
        assert tda.variant(value, loc) == want[0]
