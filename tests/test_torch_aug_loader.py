"""The augmented ScanNet loader (`aug`) against the JAX package's pieces.

- `data/voxelizer.py` `Voxelizer` with augmentation (rotation about each
  axis in a shuffled order, then scale) against the JAX one as the JAX
  loader builds it (its bounds, no clip box), each from a RandomState of
  the same seed: the same coords, feats, labels and `inds_reconstruct`,
  exactly, on several seeds.
- `ScanNetViews(aug=True)` on the miniature ScanNet of
  `tests/mini_scannet.py` against the JAX loader with queue C 1's repair
  applied to its instance (its elastic distortion's output taken whole):
  ElasticDistortion -> voxelize -> input transforms from one RandomState
  stream, the train view choice first; every field of the sample equal,
  and the seeded batches of two views equal.
- C 1 itself: the JAX loader with `aug=True` raises (it takes the first
  point of the distorted cloud), the port's does not.
"""

import numpy as np
import pytest

from mini_scannet import build_mini_scannet
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data import augmentation as jaug
from xmask3d_tpu.data import scannet as jscannet
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from xmask3d_tpu.data.voxelizer import Voxelizer as JaxVoxelizer
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.scannet import ELASTIC_DISTORT_PARAMS, ScanNetConfig, ScanNetViews
from xmask3d_tpu_torch.data.tokenizer import HashTokenizer
from xmask3d_tpu_torch.data.voxelizer import (
    ROTATION_AUGMENTATION_BOUND,
    SCALE_AUGMENTATION_BOUND,
    Voxelizer,
)

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
CAPS = (4096, 4096, 8)


def _points(seed, n=3000):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-2.0, 2.0, (n, 3)) * np.array([1.5, 1.0, 0.5])
    feats = rng.uniform(0, 255, (n, 3))
    labels = rng.randint(0, 20, n).astype(np.float64)
    return pts, feats, labels


@pytest.mark.parametrize("seed", range(8))
def test_augmenting_voxelizer_equals_jax(seed):
    assert SCALE_AUGMENTATION_BOUND == jscannet.SCALE_AUGMENTATION_BOUND
    assert ROTATION_AUGMENTATION_BOUND == jscannet.ROTATION_AUGMENTATION_BOUND
    pts, feats, labels = _points(seed)
    got_vox, rng = Voxelizer(voxel_size=0.05, use_augmentation=True), np.random.RandomState(seed)
    # the JAX loader's voxelizer (no clip box)
    want_vox = JaxVoxelizer(
        voxel_size=0.05, clip_bound=None, use_augmentation=True,
        scale_augmentation_bound=jscannet.SCALE_AUGMENTATION_BOUND,
        rotation_augmentation_bound=jscannet.ROTATION_AUGMENTATION_BOUND,
        translation_augmentation_ratio_bound=jscannet.TRANSLATION_AUGMENTATION_RATIO_BOUND,
        rng=np.random.RandomState(seed))
    for _ in range(2):  # two calls: the draws carry on in one stream
        got = got_vox.voxelize(pts, feats, labels, rng=rng)
        want = want_vox.voxelize(pts, feats, labels)
        for g, w, name in zip(got, want, ("coords", "feats", "labels", "inds_reconstruct")):
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(got[0]) < len(pts)
    with pytest.raises(ValueError, match="RandomState"):
        got_vox.voxelize(pts, feats, labels)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    return build_mini_scannet(tmp_path_factory.mktemp("scannet_aug"), n_views=2)


def _ds_kw(root):
    cfg = jax_load_config(CONFIG)
    s = cfg.category_split
    return dict(data_root=str(root / "scannet_3d"), data_root_2d=str(root / "scannet_2d"),
                caption_path=str(root / "caption.json"), label_2d=cfg.label_2d,
                base_category=s.base_category, novel_category=s.novel_category,
                ignore_category=s.ignore_category, voxel_size=cfg.voxel_size, split="train",
                aug=True)


def _repaired_jax_loader(root, seed):
    """The JAX loader with C 1's repair on this instance only: its
    elastic-distortion step hands the voxelizer the whole distorted cloud."""
    ds = jscannet.ScanNetViews(jscannet.ScanNetConfig(**_ds_kw(root)), JaxCapacities(*CAPS),
                               JaxHashTokenizer(512, 16), seed=seed)
    distort = jaug.Compose([jaug.ElasticDistortion(ELASTIC_DISTORT_PARAMS, rng=ds.rng)])
    ds.prevoxel = lambda pts: (distort(pts),)
    return ds


@pytest.mark.parametrize("seed", [3, 4])
def test_augmented_loader_equals_the_jax_pieces(mini_root, seed):
    got = ScanNetViews(ScanNetConfig(**_ds_kw(mini_root)), Capacities(*CAPS),
                       HashTokenizer(512, 16), seed=seed)
    want = _repaired_jax_loader(mini_root, seed)
    for _ in range(2):  # consecutive samples share the loaders' streams
        g, w = got.get(0), want.get(0)
        for field, wv in vars(w).items():
            np.testing.assert_array_equal(getattr(g, field), wv, err_msg=field)
    # an augmented sample differs from the plain loader's
    plain = ScanNetViews(ScanNetConfig(**{**_ds_kw(mini_root), "aug": False}),
                         Capacities(*CAPS), HashTokenizer(512, 16), seed=seed).get(0)
    assert not np.array_equal(plain.voxel_feats, g.voxel_feats)
    # a seeded batch draws everything from the RandomState of its seed
    gb = got.batch([0, 0], device="cpu", seed=11)
    want.rng.seed(11)
    wb = want.batch([0, 0])
    for key, wv in wb.items():
        if key != "hierarchy":
            np.testing.assert_array_equal(gb[key].numpy(), np.asarray(wv), err_msg=key)


def test_the_jax_augmented_loader_fails_and_the_port_does_not(mini_root):
    ds = jscannet.ScanNetViews(jscannet.ScanNetConfig(**_ds_kw(mini_root)),
                               JaxCapacities(*CAPS), JaxHashTokenizer(512, 16), seed=3)
    with pytest.raises(IndexError):
        ds.get(0)
    sample = ScanNetViews(ScanNetConfig(**_ds_kw(mini_root)), Capacities(*CAPS),
                          HashTokenizer(512, 16), seed=3).get(0)
    assert len(sample.voxel_coords) > 100
    assert len(sample.inds_reconstruct) == len(sample.labels_3d)
