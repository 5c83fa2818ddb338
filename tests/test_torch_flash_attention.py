"""Port's attention (kernel K2's module) against the JAX package.

The plain version (the kernel's CPU path) must match the JAX XLA reference
and the Pallas flash kernel in interpret mode within 1e-5 relative in fp32,
including the ragged shapes the port sends to its kernel (77 keys, 64
tokens) and the head dims of the main path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu.ops.flash_attention import flash_attention, reference_attention
from xmask3d_tpu_torch.ops import flash_attention as tfa


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for t in (tq, tk, tk)]


@pytest.mark.parametrize("tq,tk,d", [(256, 256, 40), (128, 256, 80), (256, 128, 32)])
def test_plain_matches_pallas_and_xla(tq, tk, d):
    q, k, v = _qkv(0, 1, 2, tq, tk, d)
    ref = np.asarray(reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    pallas = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        block_q=128, block_k=128, interpret=True))
    out = tfa.attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tq,tk,d", [(64, 77, 160), (100, 77, 40), (64, 64, 512)])
def test_plain_matches_xla_ragged(tq, tk, d):
    """Cross-attention over 77 text tokens, the 64-token mid block and the
    VAE's single 512-wide head."""
    q, k, v = _qkv(1, 1, 1, tq, tk, d)
    ref = np.asarray(reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = tfa.attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# which kernel a call takes on the card (`variant`, `kernel_plan`)
# --------------------------------------------------------------------------


def _full_width_attention_shapes():
    """(heads, queries, keys, head dim) of every attention call the
    full-width model makes on a 512 x 512 image with a 77-token context: the
    SD UNet's self- and cross-attention per attention level and in its mid
    block, and the VAE's single-head mid blocks."""
    from xmask3d_tpu_torch.models.ldm_extractor import LDM_SD_V1 as c

    latent = 512 // 2 ** (len(c.vae.ch_mult) - 1)
    shapes = set()
    u = c.unet
    levels = list(u.attention_levels) + [len(u.ch_mult) - 1]  # + the mid block's resolution
    for lv in levels:
        t = (latent // 2 ** lv) ** 2
        d = u.model_channels * u.ch_mult[lv] // u.num_heads
        shapes |= {(u.num_heads, t, t, d), (u.num_heads, t, c.text.context_length, d)}
    shapes.add((1, latent * latent, latent * latent, c.vae.ch * c.vae.ch_mult[-1]))
    return sorted(shapes)


def test_full_width_shapes_are_the_ones_the_card_sees():
    assert _full_width_attention_shapes() == [
        (1, 4096, 4096, 512), (8, 64, 64, 160), (8, 64, 77, 160), (8, 256, 77, 160),
        (8, 256, 256, 160), (8, 1024, 77, 80), (8, 1024, 1024, 80), (8, 4096, 77, 40),
        (8, 4096, 4096, 40)]


@pytest.mark.parametrize("h,tq,tk,d", _full_width_attention_shapes())
def test_variant_of_every_full_width_call(h, tq, tk, d):
    """bf16 goes to a tensor-core variant whose padded width holds the head
    dim, with one K/V tile exactly when the keys fit it; fp32 to the CUDA-core
    kernel. The variant depends on shapes and dtype alone."""
    q = torch.empty(1, h, tq, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, h, tk, d, dtype=torch.bfloat16, device="meta")
    name, dp, single = tfa.kernel_plan(torch.bfloat16, tk, d)
    assert tfa.variant(q, k) == name and name.startswith("mma_")
    assert dp in tfa.MMA_WIDTHS and dp >= d and dp % 16 == 0
    assert dp == min(w for w in tfa.MMA_WIDTHS if w >= d)
    assert single == (tk <= tfa.SINGLE_TILE_KEYS and dp <= 160)
    assert name.endswith("_one_tile") == single
    assert tfa.variant(q.float(), k.float()) == "fma_fp32"


@pytest.mark.parametrize("d,want", [(20, "mma_d48_ring"), (36, "mma_d48_ring"), (48, "mma_d48_ring"),
                                    (49, "mma_d80_ring"), (96, "mma_d128_ring"), (161, "mma_d512"),
                                    (512, "mma_d512")])
def test_variant_pads_odd_head_dims(d, want):
    assert tfa.kernel_plan(torch.bfloat16, 300, d)[0] == want


def test_head_dims_beyond_512_are_refused():
    q = torch.zeros(1, 1, 4, 520)
    for t in (q, q.bfloat16()):
        with pytest.raises(ValueError, match="head dim"):
            tfa.attention(t, t, t)
        with pytest.raises(ValueError, match="head dim"):
            tfa.variant(t, t)
