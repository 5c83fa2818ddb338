"""Pieces of the JAX package that no entry point reaches, in the port,
against the JAX package on the CPU.

- The voxelizer's clip box with its translation draws, with and without
  augmentation and a given centre: the same outputs from the same seeded
  `RandomState`, exactly.
- CLIP's `grid_size`, `embed_image` (with and without normalising) and
  `clamped_logit_scale` on the tiny towers with shared weights: fp32
  within 1e-5.
- `FeatureExtractorBackbone.slide_forward` on a 2 x 1 window grid: the
  window placement against the JAX method's with both backbones' window
  forward replaced by one pooling function (exact), and the port's real
  tiny backbone against its own forward on each window (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import random_variables
from xmask3d_tpu.data.voxelizer import Voxelizer as JaxVoxelizer
from xmask3d_tpu.models.backbone import FeatureExtractorBackbone as JaxBackbone
from xmask3d_tpu.models.clip import build_clip as jax_build_clip
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.data.voxelizer import (
    ROTATION_AUGMENTATION_BOUND,
    SCALE_AUGMENTATION_BOUND,
    Voxelizer,
)
from xmask3d_tpu_torch.models.backbone import FeatureExtractorBackbone
from xmask3d_tpu_torch.models.clip import build_clip
from xmask3d_tpu_torch.models.ldm_extractor import LDM_TINY

TOL = 1e-5
CLIP_BOUND = ((-1.0, 1.0), (-0.8, 0.8), (-0.5, 0.6))
TRANSLATION = ((-0.2, 0.2), (-0.2, 0.2), (0.0, 0.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("augment,center", [(True, None), (False, None),
                                            (False, (0.2, 0.1, 0.0))])
def test_voxelizer_clip_box_equals_jax(augment, center):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.0, 2.0, (3000, 3))
    feats = rng.uniform(0, 255, (3000, 3))
    labels = rng.randint(0, 20, 3000)
    want = JaxVoxelizer(voxel_size=0.05, clip_bound=CLIP_BOUND, use_augmentation=augment,
                        scale_augmentation_bound=SCALE_AUGMENTATION_BOUND,
                        rotation_augmentation_bound=ROTATION_AUGMENTATION_BOUND,
                        translation_augmentation_ratio_bound=TRANSLATION,
                        rng=np.random.RandomState(5)).voxelize(pts, feats, labels, center)
    got = Voxelizer(0.05, use_augmentation=augment, clip_bound=CLIP_BOUND,
                    translation_augmentation_ratio_bound=TRANSLATION).voxelize(
        pts, feats, labels, rng=np.random.RandomState(5), center=center)
    assert len(got[3]) < len(pts)  # the box dropped points
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_clip_pieces_equal_jax():
    jclip = jax_build_clip("ViT-tiny")
    tokens = jnp.zeros((1, 16), jnp.int32)
    image = np.random.RandomState(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(jclip.init, jax.random.PRNGKey(0), tokens, jnp.asarray(image))
    variables = random_variables(shapes, seed=4)
    clip = build_clip("ViT-tiny")
    load_jax_variables(clip, jax.device_get(variables))
    assert clip.visual.grid_size() == jclip.vision_cfg.image_size // jclip.vision_cfg.patch_size
    for normalize in (False, True):
        want = jclip.apply(variables, jnp.asarray(image), normalize,
                           method=lambda m, x, n: m.embed_image(x, normalize=n))
        with torch.no_grad():
            got = clip.embed_image(torch.from_numpy(image), normalize=normalize)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=TOL * max(1.0, float(np.abs(w).max())))
    for scale in (np.log(1 / 0.07), np.log(150.0)):
        v = {"params": {**variables["params"], "logit_scale": np.float32(scale)}}
        want = jclip.apply(v, method=lambda m: m.clamped_logit_scale())
        with torch.no_grad():
            clip.logit_scale.fill_(float(np.float32(scale)))
        np.testing.assert_allclose(clip.clamped_logit_scale().detach().numpy(), np.asarray(want),
                                   rtol=TOL)


def _pool_np(window, strides=(4, 8, 16, 32)):
    """Stand-in window forward: {"s<k>": the window average-pooled by 2^k,
    its channels and their squares}."""
    b, h, w, c = window.shape
    out = {}
    for s in strides:
        p = window.reshape(b, h // s, s, w // s, s, c).mean(axis=(2, 4))
        out[f"s{int(np.log2(s))}"] = np.concatenate([p, p * p], axis=-1)
    return out


class _JaxPooled(JaxBackbone):
    def __call__(self, image, prefix, uncond_tokens):
        b, h, w, c = image.shape
        out = {}
        for s in (4, 8, 16, 32):
            p = image.reshape(b, h // s, s, w // s, s, c).mean(axis=(2, 4))
            out[f"s{int(np.log2(s))}"] = jnp.concatenate([p, p * p], axis=-1)
        return out


def test_slide_forward_places_windows_as_jax():
    image = np.random.RandomState(2).uniform(0, 1, (1, 128, 64, 3)).astype(np.float32)
    want = _JaxPooled(ldm_cfg=LDM_TINY).apply({}, jnp.asarray(image), None, None, 64,
                                             method=JaxBackbone.slide_forward)
    port = FeatureExtractorBackbone(LDM_TINY)
    port.forward = lambda x, prefix, uncond: {k: torch.from_numpy(v)
                                              for k, v in _pool_np(x.numpy()).items()}
    got = port.slide_forward(torch.from_numpy(image), None, None, crop=64)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="multiple"):
        port.slide_forward(torch.zeros(1, 96, 64, 3), None, None, crop=64)


def test_slide_forward_of_the_tiny_backbone_is_its_forward_on_each_window():
    torch.manual_seed(0)
    port = FeatureExtractorBackbone(LDM_TINY).eval()
    image = torch.rand(1, 128, 64, 3)
    prefix = torch.randn(1, 768) * 0.1
    uncond = torch.zeros(1, 16, dtype=torch.int64)
    with torch.no_grad():
        got = port.slide_forward(image, prefix, uncond, crop=64)
        top, bottom = (port(image[:, r:r + 64], prefix, uncond) for r in (0, 64))
    for k in top:
        half = top[k].shape[1]
        assert got[k].shape[1] == 2 * half
        assert torch.equal(got[k][:, :half], top[k]) and torch.equal(got[k][:, half:], bottom[k])
