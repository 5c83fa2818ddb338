"""The port's host data path and small shared layers against the JAX package.

The port keeps its own copies of the tokenizer, voxelizer, batcher and
synthetic scenes; from one numpy seed they must produce the JAX package's
batch exactly. The JAX-exact resizes, norms with flax's eps, the tanh GELU,
the sine position embedding and the diffusion schedule are checked against
their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from xmask3d_tpu.data.voxelizer import Voxelizer as JaxVoxelizer
from xmask3d_tpu.models import diffusion as jdiff, pixel_decoder as jpd, sd_unet as junet
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.data.tokenizer import HashTokenizer, build_tokenizer
from xmask3d_tpu_torch.data.voxelizer import Voxelizer
from xmask3d_tpu_torch.models import diffusion as tdiff, layers, pixel_decoder as tpd, sd_unet as tunet


@pytest.mark.parametrize("vocab,ctx", [(49408, 77), (512, 16), (512, 4)])
def test_hash_tokenizer(vocab, ctx):
    texts = ["a room with chairs and a table", "", "  Shower   curtain ", "x " * 40]
    np.testing.assert_array_equal(HashTokenizer(vocab, ctx)(texts), JaxHashTokenizer(vocab, ctx)(texts))
    # a merges path selects the BPE tokenizer (tests/test_torch_infer_cli.py),
    # which reads the file: this repo does not ship it
    with pytest.raises(FileNotFoundError):
        build_tokenizer("bpe_simple_vocab_16e6.txt.gz")


def test_voxelizer():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 3, (2000, 3))
    colors = rng.rand(2000, 3) * 255
    labels = rng.randint(0, 20, 2000)
    got = Voxelizer(0.05).voxelize(pts, colors, labels)
    want = JaxVoxelizer(voxel_size=0.05).voxelize(pts, colors, labels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("caps,n,image", [((512, 256, 8), 400, 64), ((4096, 2048, 24), 3000, 96)])
def test_synthetic_batch_equals_jax(caps, n, image):
    kw = dict(seed=7, num_points=n, image_size=(image, image), mask_shape=(24, 32),
              context_length=16, vocab_size=512)
    want = jax_synthetic_batch(2, JaxCapacities(*caps), **kw)
    got = synthetic_batch(2, Capacities(*caps), device="cpu", **kw)
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "hierarchy":
            continue
        assert got[key].dtype == torch.from_numpy(np.asarray(w)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w), err_msg=key)
    hj, ht = want["hierarchy"], got["hierarchy"]
    for lj, lt in zip(hj.levels, ht.levels):
        for name in ("coords", "valid", "kmap3", "num"):
            np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
    for name in ("down", "up_parent", "up_octant"):
        for a, b in zip(getattr(hj, name), getattr(ht, name)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(ht.kmap5.numpy(), np.asarray(hj.kmap5))


@pytest.mark.parametrize("n_in,n_out,method,antialias", [
    (64, 8, "bicubic", False),   # the shared-noise resize at a small latent
    (16, 40, "bicubic", False),
    (16, 24, "bilinear", False),  # mask and MaskCLIP resizes
    (32, 12, "bilinear", False),
    (32, 12, "bilinear", True),
    (8, 16, "bilinear", True),    # the FPN upsample
])
def test_resize_is_jax_image_resize(n_in, n_out, method, antialias):
    """Keys' cubic with a = -0.5 and renormalised edge weights, and
    bilinear with and without antialiasing, as jax.image.resize defines them."""
    x = np.random.RandomState(n_in + n_out).randn(2, n_in, n_in + 3, 5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, n_out + 1, 5), method,
                                       antialias=antialias))
    got = layers.resize(torch.from_numpy(x), (n_out, n_out + 1), (1, 2), method,
                        antialias=antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_nearest_upsample_and_norms_and_gelu():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 6, 20, 6), "nearest"))
    np.testing.assert_array_equal(layers.upsample_nearest_int(torch.from_numpy(x), 2, 4).numpy(), want)

    y = (rng.randn(2, 4, 4, 48) * 3 + 1).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=layers.gn_groups(48))
    v = gn.init(jax.random.PRNGKey(0), y)
    np.testing.assert_allclose(layers.GroupNorm(48)(torch.from_numpy(y)).detach().numpy(),
                               np.asarray(gn.apply(v, y)), rtol=1e-5, atol=1e-5)
    ln = fnn.LayerNorm()
    v = ln.init(jax.random.PRNGKey(0), y)
    np.testing.assert_allclose(layers.LayerNorm(48)(torch.from_numpy(y)).detach().numpy(),
                               np.asarray(ln.apply(v, y)), rtol=1e-5, atol=1e-5)
    assert layers.LayerNorm(48).eps == layers.EPS == 1e-6

    z = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh").numpy(),
                               np.asarray(jax.nn.gelu(z)), rtol=1e-6, atol=1e-6)


def test_position_embedding_timestep_and_diffusion():
    np.testing.assert_array_equal(tpd.position_embedding_sine(5, 7, 16),
                                  jpd.position_embedding_sine(5, 7, 16))
    np.testing.assert_array_equal(tpd._offsets_init(8, 3, 4), jpd._offsets_init(8, 3, 4))
    t = np.array([0, 10, 999], np.int32)
    np.testing.assert_allclose(tunet.timestep_embedding(torch.from_numpy(t), 32).numpy(),
                               np.asarray(junet.timestep_embedding(jnp.asarray(t), 32)),
                               rtol=1e-5, atol=1e-5)
    jd = jdiff.GaussianDiffusion.create(1000, "ldm_linear")
    td = tdiff.GaussianDiffusion(1000, "ldm_linear")
    np.testing.assert_array_equal(td.betas, jd.betas)
    rng = np.random.RandomState(2)
    x0, noise = rng.randn(3, 4, 4, 4).astype(np.float32), rng.randn(3, 4, 4, 4).astype(np.float32)
    want = np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
