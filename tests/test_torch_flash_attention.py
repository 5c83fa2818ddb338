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
