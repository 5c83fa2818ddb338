"""The port's whole-scene inference against the JAX package.

- The host helpers (nearest-covered match, KD-tree fill, view ids, scene
  voter, IoU meters) and the 2D fill-and-route: exact.
- The data the CLI reads: `synthetic_scene`, `ScanNetSceneViews.scene` and
  a train-split view on the miniature on-disk dataset
  (tests/mini_scannet.py), the point-cloud augmentations, the BPE
  tokenizer on a merges file written here: exact.
- The tiny model in fp32 through both packages' `run_eval_scenes` on two
  synthetic scenes with shared weights and the fused GroupNorm -> SiLU ->
  conv path on (JAX: its fused branch forced on, which runs its oracle off
  the TPU; the port: `fused_gn=True`, K4's plain version on the CPU). Every
  stream's per-point predictions must agree on >= 99% of the points (a
  discrete output can flip at a near-tie between the two frameworks' fp32
  sums), and each IoU accumulator may move by no more than the points that
  disagree.
- The port's CLI through both branches, on the CPU.
"""

import gzip
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmask3d_tpu.engine.infer_cli as jcli
import xmask3d_tpu.models.vae as jvae
from mini_scannet import build_mini_scannet
from test_torch_model import TINY, random_variables
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.scannet import ScanNetConfig as JaxScanNetConfig
from xmask3d_tpu.data.scannet import ScanNetSceneViews as JaxScanNetSceneViews
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.data.synthetic import synthetic_scene as jax_synthetic_scene
from xmask3d_tpu.data.tokenizer import CLIPBPETokenizer as JaxCLIPBPETokenizer
from xmask3d_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from xmask3d_tpu.engine import infer as jinfer
from xmask3d_tpu.engine.builder import data_tokenizer as jax_data_tokenizer
from xmask3d_tpu.engine.builder import model_config_from_cfg, zero_statics
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.scannet import ScanNetConfig, ScanNetSceneViews
from xmask3d_tpu_torch.data.synthetic import synthetic_scene
from xmask3d_tpu_torch.data.tokenizer import (
    CLIPBPETokenizer,
    HashTokenizer,
    build_tokenizer,
    require_real_tokenizer,
)
from xmask3d_tpu_torch.engine import infer
from xmask3d_tpu_torch.engine import infer_cli
from xmask3d_tpu_torch.engine.builder import build_model, capacities_from_cfg, data_tokenizer

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
SCENE_CAPS = {"max_points": 1024, "max_voxels": 1024}
STREAMS = ("pred", "pred_2d", "pred_3d")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# host helpers
# --------------------------------------------------------------------------


def test_nearest_covered_match_and_kdtree_fill():
    rng = np.random.RandomState(0)
    coords = rng.rand(300, 3).astype(np.float32)
    covered, valid = rng.rand(300) < 0.4, rng.rand(300) < 0.9
    for cov in (covered, np.zeros(300, bool), np.ones(300, bool)):
        np.testing.assert_array_equal(infer.nearest_covered_match(coords, cov, valid),
                                      jinfer.nearest_covered_match(coords, cov, valid))
    values = rng.randint(0, 19, 300)
    for known in (covered, np.zeros(300, bool), np.ones(300, bool)):
        np.testing.assert_array_equal(infer.kdtree_fill(coords, values, known),
                                      jinfer.kdtree_fill(coords, values, known))


def test_view_scene_ids_and_scene_voter():
    rng = np.random.RandomState(1)
    visible = rng.rand(500) < 0.5
    pv = rng.rand(200) < 0.8
    scene_pv = rng.rand(400) < 0.9
    for args in ((visible, pv), (visible, pv, scene_pv), (np.ones(100, bool), pv)):
        for got, want in zip(infer.view_scene_ids(*args), jinfer.view_scene_ids(*args)):
            np.testing.assert_array_equal(got, want)
    coords = rng.rand(500, 3)
    got, want = infer.SceneVoter(500, 19), jinfer.SceneVoter(500, 19)
    for _ in range(3):
        ids = rng.choice(500, 150, replace=False)
        preds = rng.randint(0, 19, 150)
        got.add_view(ids, preds)
        want.add_view(ids, preds)
    np.testing.assert_array_equal(got.votes, want.votes)
    np.testing.assert_array_equal(got.finalize(coords), want.finalize(coords))


def test_iou_meters():
    rng = np.random.RandomState(2)
    base, novel = (0, 1, 2, 3, 4, 6, 7, 8, 10, 11, 13, 14, 15, 17, 18), (5, 9, 12, 16)
    gt = rng.randint(0, 19, 1000)
    gt[:50] = 255
    pred = np.where(rng.rand(1000) < 0.6, gt, rng.randint(0, 19, 1000))
    got = infer.evaluate_scene_predictions(pred, gt, 19, base, novel, ignore=(255, 19))
    want = jinfer.evaluate_scene_predictions(pred, gt, 19, base, novel, ignore=(255, 19))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert infer.summarize_iou(got, base, novel) == jinfer.summarize_iou(want, base, novel)


def test_fill_and_route_2d():
    rng = np.random.RandomState(3)
    feat = rng.randn(1, 64, 24).astype(np.float32)
    match = rng.randint(0, 64, (1, 64)).astype(np.int32)
    binary = (rng.rand(1, 64) < 0.5).astype(np.float32)
    text = rng.randn(19, 24).astype(np.float32)
    base, novel = (0, 1, 2, 3, 4, 6, 7, 8, 10, 11, 13, 14, 15, 17, 18), (5, 9, 12, 16)
    want = jinfer.fill_and_route_2d(jnp.asarray(feat), jnp.asarray(match), jnp.asarray(binary),
                                    jnp.asarray(text), jnp.asarray(14.3), base, novel)
    got = infer.fill_and_route_2d(*(torch.from_numpy(a) for a in (feat, match, binary, text)),
                                  torch.tensor(14.3), base, novel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the data the CLI reads
# --------------------------------------------------------------------------


def _assert_scene_equal(got, want):
    assert got["name"] == want["name"] and len(got["views"]) == len(want["views"]) > 0
    for key in ("coords", "colors", "labels"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for gv, wv in zip(got["views"], want["views"]):
        np.testing.assert_array_equal(gv["visible"], wv["visible"])
        for field, w in vars(wv["sample"]).items():
            g = getattr(gv["sample"], field)
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def test_synthetic_scene_equals_jax():
    kw = dict(seed=5, num_points=1500, num_views=3, num_classes=19)
    _assert_scene_equal(synthetic_scene(Capacities(1024, 512, 8), **kw),
                        jax_synthetic_scene(JaxCapacities(1024, 512, 8), **kw))


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    return build_mini_scannet(tmp_path_factory.mktemp("scannet_torch"), n_views=2)


def _ds_kw(root, split):
    cfg = jax_load_config(CONFIG)
    s = cfg.category_split
    return dict(data_root=str(root / "scannet_3d"), data_root_2d=str(root / "scannet_2d"),
                caption_path=str(root / "caption.json"), label_2d=cfg.label_2d,
                base_category=s.base_category, novel_category=s.novel_category,
                ignore_category=s.ignore_category, voxel_size=cfg.voxel_size, split=split)


def test_scannet_scene_equals_jax(mini_root):
    caps = (4096, 4096, 8)
    got = ScanNetSceneViews(ScanNetConfig(**_ds_kw(mini_root, "val")), Capacities(*caps),
                            HashTokenizer(512, 16)).scene(0)
    want = JaxScanNetSceneViews(JaxScanNetConfig(**_ds_kw(mini_root, "val")), JaxCapacities(*caps),
                                JaxHashTokenizer(512, 16)).scene(0)
    _assert_scene_equal(got, want)


def test_scannet_train_batch_equals_jax(mini_root):
    """The train split: the seeded random view choice and the label
    compaction, as in the JAX package, then the batch without the grid
    jitter, and the loaders' train batches, whose grid jitter is drawn from
    the same seeded rng."""
    caps = (4096, 4096, 8)
    kw = _ds_kw(mini_root, "train")
    from xmask3d_tpu.data.batching import collate_views as jax_collate_views
    from xmask3d_tpu.data.scannet import ScanNetViews as JaxScanNetViews
    from xmask3d_tpu_torch.data.batching import collate_views
    from xmask3d_tpu_torch.data.scannet import ScanNetViews

    got_s = ScanNetViews(ScanNetConfig(**kw), Capacities(*caps), HashTokenizer(512, 16),
                         seed=3).get(0)
    want_s = JaxScanNetViews(JaxScanNetConfig(**kw), JaxCapacities(*caps),
                             JaxHashTokenizer(512, 16), seed=3).get(0)
    for field, w in vars(want_s).items():
        np.testing.assert_array_equal(getattr(got_s, field), w, err_msg=field)
    got = collate_views([got_s], Capacities(*caps), device="cpu")
    want = jax_collate_views([want_s], JaxCapacities(*caps), num_base=len(kw["base_category"]))
    for key, w in want.items():
        if key != "hierarchy":
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w), err_msg=key)
    for lt, lj in zip(got["hierarchy"].levels, want["hierarchy"].levels):
        np.testing.assert_array_equal(lt.coords.numpy(), np.asarray(lj.coords))
    got = ScanNetViews(ScanNetConfig(**kw), Capacities(*caps), HashTokenizer(512, 16),
                       seed=3).batch([0, 1], device="cpu")
    want = JaxScanNetViews(JaxScanNetConfig(**kw), JaxCapacities(*caps),
                           JaxHashTokenizer(512, 16), seed=3).batch([0, 1])
    for key, w in want.items():
        if key != "hierarchy":
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w), err_msg=key)
    for lt, lj in zip(got["hierarchy"].levels, want["hierarchy"].levels):
        np.testing.assert_array_equal(lt.coords.numpy(), np.asarray(lj.coords))
        np.testing.assert_array_equal(lt.kmap3.numpy(), np.asarray(lj.kmap3))
    with pytest.raises(NotImplementedError, match="not ported"):
        ScanNetViews(ScanNetConfig(**kw, aug=True), Capacities(*caps), HashTokenizer(512, 16))


@pytest.mark.parametrize("name,args", [
    ("ChromaticTranslation", (0.1,)),
    ("ChromaticAutoContrast", ()),
    ("ChromaticJitter", (0.05,)),
    ("HueSaturationTranslation", (0.5, 0.2)),
    ("RandomHorizontalFlip", ("z",)),
    ("ElasticDistortion", (((0.2, 0.4), (0.8, 1.6)),)),
])
def test_augmentation_equals_jax(name, args):
    """Each point-cloud augmentation, drawn from one seeded RandomState, gives
    the JAX package's arrays (several draws, so each random branch runs)."""
    from xmask3d_tpu.data import augmentation as jaug
    from xmask3d_tpu_torch.data import augmentation as taug

    data = np.random.RandomState(0)
    coords = data.rand(300, 3) * 2.0
    feats = data.rand(300, 3) * 255.0
    labels = data.randint(0, 20, 300)
    got_t = taug.Compose([getattr(taug, name)(*args, rng=np.random.RandomState(1))])
    want_t = jaug.Compose([getattr(jaug, name)(*args, rng=np.random.RandomState(1))])
    for _ in range(6):
        for g, w in zip(got_t(coords, feats, labels), want_t(coords, feats, labels)):
            np.testing.assert_array_equal(g, w)


_MERGES = ["c a", "ca t</w>", "p h", "h e", "he l", "hel l", "o f</w>", "a t</w>", "w o",
           "wo r", "l d</w>", "o t", "ph ot", "phot o</w>", "t h", "th e</w>", "i s</w>",
           "1 2", "e r", "er e</w>"]


def test_clip_bpe_tokenizer_equals_jax(tmp_path):
    path = tmp_path / "bpe_mini.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: mini\n" + "\n".join(_MERGES) + "\n")
    texts = ["a photo of a cat", "hello world!!", "The cat is here, obviously.",
             "it's 42 degrees", "photo-of-a-cat's cathedral", "", "x " * 90]
    for ctx in (77, 16):
        got = build_tokenizer(str(path), context_length=ctx)
        want = JaxCLIPBPETokenizer(str(path), ctx)
        assert isinstance(got, CLIPBPETokenizer) and (got.sot, got.eot) == (want.sot, want.eot)
        for t in texts:
            assert got.encode(t) == want.encode(t), t
        np.testing.assert_array_equal(got(texts), want(texts))
    with pytest.raises(RuntimeError, match="HashTokenizer"):
        require_real_tokenizer(HashTokenizer())
    require_real_tokenizer(HashTokenizer(), allow_hash=True)
    require_real_tokenizer(got)


def test_builder_helpers_match_jax():
    cfg, jcfg = load_config(CONFIG), jax_load_config(CONFIG)
    for c in (cfg, jcfg):
        c.update(max_points=777, max_voxels=333)
    caps = capacities_from_cfg(cfg)
    assert (caps.max_points, caps.max_voxels, caps.max_targets) == (777, 333, 24)
    for tiny in (False, True):
        got, want = data_tokenizer(cfg, tiny), jax_data_tokenizer(jcfg, tiny)
        assert (got.vocab_size, got.context_length) == (want.vocab_size, want.context_length)


# --------------------------------------------------------------------------
# whole scenes through both packages, fused GroupNorm -> SiLU -> conv on
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes_both():
    mp = pytest.MonkeyPatch()
    mp.setattr(jvae, "fused_available", lambda *a, **k: True)
    try:
        jcfg = jax_load_config(CONFIG)
        jcfg.update(TINY, **SCENE_CAPS)
        caps = JaxCapacities(max_points=1024, max_voxels=1024, max_targets=8)
        kw = dict(image_size=(64, 64), mask_shape=(24, 32), context_length=16, vocab_size=512)
        batch0 = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(
            1, caps, seed=0, num_points=400, num_classes=jcfg.classes, **kw))
        model = JaxXMask3D(cfg=model_config_from_cfg(jcfg, tiny=True))
        rngs = {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)}
        shapes = jax.eval_shape(partial(model.init, train=True), rngs, batch0,
                                zero_statics(model, jcfg))
        variables = random_variables({"params": shapes["params"],
                                      "batch_stats": shapes["batch_stats"]}, seed=4)
        tok = jax_data_tokenizer(jcfg, tiny=True)
        bank = jax.jit(lambda v, t: model.apply(v, t, method=lambda m, x: m.embed_captions(x)))
        statics = {
            "text_embed_train": bank(variables, jnp.asarray(tok(list(jcfg.label)))),
            "text_embed_test": bank(variables, jnp.asarray(tok(list(jcfg.all_label)))),
            "uncond_tokens": jnp.asarray(tok([""])),
        }
        skw = dict(num_points=1000, num_views=3, num_classes=jcfg.test_classes, **kw)
        jax_preds, jax_accs = [], []
        run_scene, evaluate = jcli.run_scene, jcli.evaluate_scene_predictions

        def keep_preds(*a, **k):
            jax_preds.append(run_scene(*a, **k))
            return jax_preds[-1]

        def keep_acc(*a, **k):
            jax_accs.append(evaluate(*a, **k))
            return jax_accs[-1]

        mp.setattr(jcli, "run_scene", keep_preds)
        mp.setattr(jcli, "evaluate_scene_predictions", keep_acc)
        infer_step, route_2d = jcli.make_infer_step(model, jcfg)
        want = jcli.run_eval_scenes(
            [jax_synthetic_scene(caps, seed=100 + i, **skw) for i in range(2)], 2, cfg=jcfg,
            caps=caps, variables=variables, statics=statics, infer_step=infer_step,
            route_2d=route_2d, num_base=jcfg.classes)
    finally:
        mp.undo()

    pcfg = load_config(CONFIG)
    pcfg.update(TINY, **SCENE_CAPS)
    port = build_model(pcfg, tiny=True, device="cpu", fused_gn=True)
    load_jax_variables(port, jax.device_get(variables))
    pstep, proute = infer_cli.make_infer_step(port, pcfg)
    record = []
    got = infer_cli.run_eval_scenes(
        [synthetic_scene(Capacities(1024, 1024, 8), seed=100 + i, **skw) for i in range(2)], 2,
        cfg=pcfg, caps=Capacities(1024, 1024, 8),
        statics={k: torch.from_numpy(np.array(v)) for k, v in statics.items()},
        infer_step=pstep, route_2d=proute, device="cpu", record=record)
    return {"want": want, "got": got, "record": record, "jax_preds": jax_preds,
            "jax_accs": jax_accs, "port": port}


def test_run_eval_scenes_with_fused_gn_matches_jax(scenes_both):
    port = scenes_both["port"]
    blocks = [m for m in port.modules() if type(m).__name__ == "ResnetBlock"]
    assert blocks and all(m.fused_gn for m in blocks)
    record = scenes_both["record"]
    assert len(record) == len(scenes_both["jax_preds"]) == 2
    for i, rec in enumerate(record):
        for s in STREAMS:
            got, want = rec["pred"][s], scenes_both["jax_preds"][i][s]
            assert got.shape == want.shape
            n_dis = int((got != want).sum())
            print(f"scene {i} {s}: {n_dis} of {len(got)} points disagree")
            assert n_dis <= 0.01 * len(got)
            want_acc = scenes_both["jax_accs"][3 * i + STREAMS.index(s)]
            for k in ("inter", "union", "target"):
                assert np.abs(rec["acc"][s][k] - want_acc[k]).max() <= n_dis, (s, k)
        assert rec["views"] == 3
        assert rec["counter"] == {s: rec["kept"] for s in STREAMS}
    for key, v in scenes_both["got"].items():
        assert np.isfinite(v), key
    assert set(scenes_both["got"]) == set(scenes_both["want"])


# --------------------------------------------------------------------------
# the CLI, both branches
# --------------------------------------------------------------------------


def _check_summary(summary):
    assert summary is not None
    for k in ("hIoU", "mIoU", "hIoU_2d", "hIoU_3d", "scenes_per_sec"):
        assert np.isfinite(summary[k]), k


def test_cli_synthetic_branch(monkeypatch):
    monkeypatch.setenv("XMASK3D_FUSED_GN", "1")
    _check_summary(infer_cli.main(
        ["--config", CONFIG, "--synthetic", "--tiny", "--num_scenes", "1",
         "max_points", "512", "max_voxels", "256", "max_targets", "8", "mask_shape", "[24,32]"],
        device="cpu"))


def test_cli_scannet_branch(mini_root):
    argv = ["--config", CONFIG, "--tiny", "data_root", str(mini_root / "scannet_3d"),
            "data_root_2d", str(mini_root / "scannet_2d"),
            "caption_path", str(mini_root / "caption.json"),
            "max_points", "4096", "max_voxels", "4096", "max_targets", "8",
            "mask_shape", "[24,32]"]
    with pytest.raises(RuntimeError, match="HashTokenizer"):
        infer_cli.main(argv, device="cpu")
    _check_summary(infer_cli.main(argv[:2] + ["--allow_hash_tokenizer"] + argv[2:], device="cpu"))
