"""The port's converters, model zoo and conversion CLI against the JAX
package's (`checkpoint/convert_torch.py`, `checkpoint/convert_xmask3d.py`,
`utils/model_zoo.py`, `tools/convert_checkpoints.py`).

- `me_offset_permutation` and `convert_me_kernel` equal the JAX ones for
  k = 1, 2, 3 and 5 (the offset order itself is pinned against
  MinkowskiEngine only by a golden test that needs the reference sources).
- SD VAE, UNet and text encoder, and open_clip, at tiny width: the
  reference-format dicts come from the port's test-support inverse
  (`checkpoint/ref_format.py`), whose SD names agree with the inverse
  helpers of `tests/test_converters*.py`; both packages' converters then
  give the same keys, dtypes and bytes, and those equal the module's own
  weights in flax layout.
- The trainables at full width, for B15N4 and for the ScanNet200 B170N30
  (170 classes), from `tests/ref_state_dict.py`'s manifest: both
  converters give the same keys, dtypes and bytes; every converted path
  lands on a tensor of the port's full-width model, built on the meta
  device, and every trainable tensor of that model is covered.
  `ref_format`'s trainables part gives exactly the manifest's keys (the
  manifest was written from the reference sources, not from the
  converter). Shapes agree everywhere but at the input widths of the
  backbone projections of the four UNet taps (`UNET_TAP_WIDTHS`, ROADMAP
  C 10): the manifest gives them the width of the output blocks, both
  packages' models the concatenated [h, skip] input of those blocks.
- The port's CLI and `scripts/convert_checkpoints.py`'s `main`, on the same
  tiny files written with torch.save, write npz files equal key for key
  and byte for byte.
- The whole-scene CLI serves the converters' npz of a tiny model with
  `--converted`, with and without `--scene_reuse`.
- `sd://` and `odise://` names resolve under `XMASK3D_MODEL_ZOO` as the
  JAX package resolves them; a missing file raises.
"""

import numpy as np
import pytest
import torch

import xmask3d_tpu.checkpoint.convert_torch as jct
import xmask3d_tpu.checkpoint.convert_xmask3d as jcx
import xmask3d_tpu_torch.checkpoint.convert_torch as tct
import xmask3d_tpu_torch.checkpoint.convert_xmask3d as tcx
from ref_state_dict import xmask3d_state_dict_manifest
from test_converters import _vae_torch_key
from test_converters_unet import _unet_torch_key
from xmask3d_tpu_torch.checkpoint import ref_format as rf
from xmask3d_tpu_torch.checkpoint.from_jax import bridge_tensors
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.engine.builder import model_config_from_cfg
from xmask3d_tpu_torch.models.clip import CLIP, VIT_TINY, CLIPTextConfig, CLIPVisionConfig
from xmask3d_tpu_torch.models.ldm_extractor import LDM_TINY, LdmConfig, LdmExtractor
from xmask3d_tpu_torch.models.xmask3d import XMask3D

CONFIGS = {"B15N4": "configs/scannet/xmask3d_scannet_B15N4.yaml",
           "B170N30": "configs/scannet/xmask3d_scannet_B170N30.yaml"}
# backbone projection -> (input width in the manifest, in both packages'
# models): the UNet taps 2, 5, 8 and 11, where the two disagree
UNET_TAP_WIDTHS = {2: (1280, 2560), 3: (1280, 1920), 4: (640, 960), 5: (320, 640)}


def _apart(path_or_key: str):
    """The UNet-tap projection a conv1 / shortcut kernel belongs to, or None."""
    import re

    m = re.fullmatch(r"backbone[/.](?:proj_|feature_projections\.)(\d)(?:\.0)?[/.]"
                     r"(?:conv1|shortcut)[/.](?:kernel|weight)", path_or_key)
    return int(m[1]) if m and int(m[1]) in UNET_TAP_WIDTHS else None


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_arrays(got, want):
    """The same keys, and per key the same dtype, shape and bytes."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        w, g = np.asarray(w), np.asarray(g)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_me_offsets_and_kernels_equal_jax(k):
    p = tct.me_offset_permutation(k)
    np.testing.assert_array_equal(p, jct.me_offset_permutation(k))
    assert sorted(p.tolist()) == list(range(k ** 3))
    w = np.random.RandomState(k).randn(k ** 3, 3, 4).astype(np.float32)
    got = tct.convert_me_kernel(w)
    assert_same_arrays({"w": got}, {"w": jct.convert_me_kernel(w)})
    # ref_format's inverse takes it back to ME's layout (k = 1: a 2-D kernel)
    back = rf._me_kernel(got)
    np.testing.assert_array_equal(back, w[0] if k == 1 else w)
    w2 = w[0]  # ME stores kernel size 1 as (C_in, C_out)
    assert_same_arrays({"w": tct.convert_me_kernel(w2)}, {"w": jct.convert_me_kernel(w2)})


@pytest.fixture(scope="module")
def tiny_ldm():
    torch.manual_seed(0)
    return LdmExtractor(LDM_TINY)


def test_sd_names_agree_with_the_converter_tests_inverse(tiny_ldm):
    """ref_format's SD names against `_vae_torch_key` / `_unet_torch_key`,
    leaf by leaf."""
    flat = rf.flat_weights(tiny_ldm)["params"]
    sd = rf.sd_state_dict(tiny_ldm)
    want = set()
    for path in flat:
        parts = path.split("/")
        if parts[0] == "vae":
            want.add(_vae_torch_key(parts[1:], LDM_TINY.vae))
        elif parts[0] == "unet":
            want.add(_unet_torch_key(parts[1:], LDM_TINY.unet))
    assert {k for k in sd if not k.startswith("cond_stage_model")} == want


def test_sd_converters_equal_jax_at_tiny_width(tiny_ldm):
    c = LDM_TINY
    sd = _np(rf.sd_state_dict(tiny_ldm))
    flat = rf.flat_weights(tiny_ldm)["params"]
    for name, kw in (("vae", dict(ch_mult=c.vae.ch_mult, num_res_blocks=c.vae.num_res_blocks)),
                     ("unet", dict(ch_mult=c.unet.ch_mult, num_res_blocks=c.unet.num_res_blocks,
                                   attention_levels=c.unet.attention_levels)),
                     ("text_encoder", dict(layers=c.text.layers))):
        got = getattr(tct, f"convert_sd_{name}")(sd, **kw)
        assert_same_arrays(got, getattr(jct, f"convert_sd_{name}")(sd, **kw))
        # the round trip gives the module's own weights (SD has no text
        # projection: the converter writes identity there)
        own = {k[len(name) + 1:]: v for k, v in flat.items() if k.startswith(name + "/")}
        if name == "text_encoder":
            np.testing.assert_array_equal(got.pop("text_projection"), np.eye(c.text.width))
            own.pop("text_projection")
        assert_same_arrays(got, own)


def test_open_clip_converter_equals_jax_at_tiny_width():
    torch.manual_seed(1)
    clip = CLIP(*VIT_TINY)
    sd = _np(rf.open_clip_state_dict(clip))
    kw = dict(text_layers=VIT_TINY[0].layers, vision_layers=VIT_TINY[1].layers)
    got = tct.convert_open_clip(sd, **kw)
    assert_same_arrays(got, jct.convert_open_clip(sd, **kw))
    assert_same_arrays(got, rf.flat_weights(clip)["params"])


def _lazy_state_dict(manifest):
    """Every manifest key as a distinct constant, broadcast (no memory)."""
    return {k: (np.asarray(0, np.int64) if k.endswith("num_batches_tracked")
                else np.broadcast_to(np.float32(i + 1), shape))
            for i, (k, shape) in enumerate(sorted(manifest.items()))}


def _meta_model(name):
    cfg = load_config(CONFIGS[name])
    with torch.device("meta"):
        return XMask3D(model_config_from_cfg(cfg)), cfg


def _port_shapes(model):
    """{(collection, jax path): (transform, torch shape)}."""
    return {(b.collection, b.path): (b.transform, tuple(b.tensor.shape))
            for b in bridge_tensors(model)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_width_trainables_convert_identically_and_land(name):
    model, cfg = _meta_model(name)
    manifest = xmask3d_state_dict_manifest(arch_3d=cfg.arch_3d, arch_binary=cfg.arch_binary_head,
                                           num_classes=cfg.classes, num_queries=cfg.num_queries)
    sd = {f"module.{k}": v for k, v in _lazy_state_dict(manifest).items()}
    tp, ts = tcx.convert_xmask3d_checkpoint(sd, arch_3d=cfg.arch_3d,
                                            arch_binary=cfg.arch_binary_head)
    jp, js = jcx.convert_xmask3d_checkpoint(sd, arch_3d=cfg.arch_3d,
                                            arch_binary=cfg.arch_binary_head)
    assert_same_arrays(tp, jp)
    assert_same_arrays(ts, js)
    port = _port_shapes(model)
    converted = {("params", k): v for k, v in tp.items()}
    converted.update({("batch_stats", k): v for k, v in ts.items()})
    apart = []
    for key, arr in converted.items():
        assert key in port, key
        fn, shape = port[key]
        view = np.broadcast_to(np.float32(0), arr.shape)
        got = tuple((fn(view) if fn else view).shape)
        tap = _apart(key[1])
        if tap is None:
            assert got == shape, key
        else:
            apart.append(tap)
            assert (got[1], shape[1]) == UNET_TAP_WIDTHS[tap], key
            assert got[:1] + got[2:] == shape[:1] + shape[2:], key
    assert sorted(apart) == sorted(list(UNET_TAP_WIDTHS) * 2)
    trainable = {k for k in port
                 if not (k[1].startswith(rf.LDM + "/") or k[1].startswith("clip/"))}
    assert trainable == set(converted)


def _materialize_trainables(model):
    """The trainable submodules of a meta-built model on the CPU (values
    unset): everything but the SD towers and CLIP."""
    for child_name, child in model.named_children():
        if child_name == "clip":
            continue
        if child_name != "backbone":
            child.to_empty(device="cpu")
            continue
        for sub_name, sub in child.named_children():
            if sub_name != "feature_extractor":
                sub.to_empty(device="cpu")
                continue
            sub.to_empty(device="cpu", recurse=False)
            for part_name, part in sub.named_children():
                if part_name != "ldm_extractor":
                    part.to_empty(device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ref_format_trainables_are_the_manifest(name):
    model, cfg = _meta_model(name)
    _materialize_trainables(model)
    with torch.no_grad():
        for p in model.parameters():
            if not p.is_meta:
                p.zero_()
    got = {k: tuple(v.shape) for k, v in rf.xmask3d_state_dict(model).items()}
    manifest = xmask3d_state_dict_manifest(arch_3d=cfg.arch_3d, arch_binary=cfg.arch_binary_head,
                                           num_classes=cfg.classes, num_queries=cfg.num_queries)
    assert sorted(got) == sorted(manifest)
    for k, shape in manifest.items():
        tap = _apart(k)
        if tap is None:
            assert got[k] == shape, k
        else:
            assert (shape[1], got[k][1]) == UNET_TAP_WIDTHS[tap], k
    ckpt = rf.released_checkpoint(got)
    assert set(ckpt) == {"epoch", "state_dict", "optimizer", "best_iou"}
    assert all(k.startswith("module.") for k in ckpt["state_dict"])


# --------------------------------------------------------------------------- #
# the conversion CLI on tiny files in the released layouts
# --------------------------------------------------------------------------- #


def _shrunk(manifest, most=6):
    """The manifest's keys with every width cut to `most` (ME kernels keep
    their offset axis), so the converter's defaults still apply."""
    out = {}
    for k, shape in manifest.items():
        keep = 1 if k.endswith(".kernel") and len(shape) == 3 else 0
        out[k] = tuple(d if i < keep else min(d, most) for i, d in enumerate(shape))
    return out


def write_tiny_released(directory):
    """Tiny files in the three released layouts, with the converters' default
    depths (12 text layers, 24 vision layers, 9 decoder layers, the
    MinkUNet34C / 18A block counts) at tiny widths: {"sd", "clip", "xmask3d"}
    paths."""
    torch.manual_seed(2)
    text = CLIPTextConfig(vocab_size=64, context_length=8, width=24, layers=12, heads=2,
                          embed_dim=24)
    ldm = LdmExtractor(LdmConfig(vae=LDM_TINY.vae, unet=LDM_TINY.unet, text=text))
    clip = CLIP(CLIPTextConfig(vocab_size=64, context_length=8, width=8, layers=12, heads=2,
                               embed_dim=8),
                CLIPVisionConfig(image_size=16, patch_size=8, width=8, layers=24, heads=2,
                                 embed_dim=8))
    rng = np.random.RandomState(0)
    manifest = _shrunk(xmask3d_state_dict_manifest())
    trainables = {k: (torch.tensor(0) if k.endswith("num_batches_tracked")
                      else torch.from_numpy(np.asarray(rng.randn(*shape), np.float32)))
                  for k, shape in sorted(manifest.items())}
    paths = {"sd": str(directory / "sd.ckpt"), "clip": str(directory / "clip.pt"),
             "xmask3d": str(directory / "xmask3d.pth.tar")}
    torch.save({"state_dict": rf.sd_state_dict(ldm)}, paths["sd"])
    torch.save(rf.open_clip_state_dict(clip), paths["clip"])
    torch.save(rf.released_checkpoint(trainables), paths["xmask3d"])
    return paths


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_the_cli_writes_the_jax_scripts_npz(tmp_path, monkeypatch):
    import importlib.util

    from xmask3d_tpu_torch.tools import convert_checkpoints as cli

    paths = write_tiny_released(tmp_path)
    args = ["--xmask3d", paths["xmask3d"], "--sd", paths["sd"], "--clip", paths["clip"]]
    counts = cli.main(args + ["--out", str(tmp_path / "port.npz")])
    spec = importlib.util.spec_from_file_location("jax_convert_script",
                                                  "scripts/convert_checkpoints.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr("sys.path", list(__import__("sys").path))  # the script inserts "."
    script.main(args + ["--out", str(tmp_path / "jax.npz")])
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    assert_same_arrays(got, want)
    assert counts == {"params": sum(k.startswith("params/") for k in got),
                      "batch_stats": sum(k.startswith("batch_stats/") for k in got)}
    assert counts["batch_stats"] > 0 and any(k.startswith("params/clip/visual/") for k in got)
    assert any(k.startswith(f"params/{rf.LDM}/unet/") for k in got)


def test_model_zoo_resolves_as_jax_and_never_downloads(tmp_path, monkeypatch):
    from xmask3d_tpu.utils import model_zoo as jzoo
    from xmask3d_tpu_torch.utils import model_zoo as zoo

    monkeypatch.setenv("XMASK3D_MODEL_ZOO", str(tmp_path))
    assert zoo.cache_dir() == jzoo.cache_dir() == str(tmp_path)
    (tmp_path / "b15n4.pth.tar").write_bytes(b"")
    (tmp_path / "sd-v1-3.ckpt").write_bytes(b"")
    for name in ("odise://b15n4", "sd://v1-3", "relative/plain.ckpt"):
        assert zoo.resolve(name) == jzoo.resolve(name)
    assert zoo.resolve("odise://b15n4") == str(tmp_path / "b15n4.pth.tar")
    for name in ("odise://b170n30", "sd://v1-5"):
        with pytest.raises(FileNotFoundError, match=str(tmp_path)):
            zoo.resolve(name)


@pytest.mark.parametrize("scene_reuse", [False, True])
def test_the_infer_cli_serves_the_converters_npz(tmp_path, scene_reuse):
    """A tiny model's weights in the released layouts, through the port's
    converters into the CLI's npz, served by `--converted` (with and without
    `--scene_reuse`): from the CLI's own seed the summary is the plain
    run's exactly; from another seed it differs (the npz was applied)."""
    from xmask3d_tpu_torch.engine import infer_cli
    from xmask3d_tpu_torch.engine.builder import build_model
    from xmask3d_tpu_torch.models.clip import CLIP_CONFIGS

    opts = {"arch_3d": "MinkUNet18A", "arch_binary_head": "MinkUNet18A", "mask_shape": "[24,32]",
            "compute_dtype": "float32", "max_points": 512, "max_voxels": 256, "max_targets": 8,
            "dec_layers": 2}
    cfg = load_config(CONFIGS["B15N4"])
    cfg.update({k: v for k, v in opts.items() if k != "mask_shape"}, mask_shape=[24, 32])
    argv = ["--config", CONFIGS["B15N4"], "--synthetic", "--tiny", "--num_scenes", "1"]
    argv += ["--scene_reuse"] if scene_reuse else []
    tail = [str(x) for kv in opts.items() for x in kv]
    summaries = {"plain": infer_cli.main(argv + tail, device="cpu")}
    for seed in (0, 3):
        model = build_model(cfg, tiny=True, seed=seed, device="cpu")
        ldm = model.backbone.feature_extractor.ldm_extractor
        c, (tc, vc) = ldm.cfg, CLIP_CONFIGS[model.cfg.clip_name]
        sd = _np(rf.sd_state_dict(ldm))
        params = {}
        for name, tree in (
                ("vae", tct.convert_sd_vae(sd, c.vae.ch_mult, c.vae.num_res_blocks)),
                ("unet", tct.convert_sd_unet(sd, c.unet.ch_mult, c.unet.num_res_blocks,
                                             c.unet.attention_levels)),
                ("text_encoder", tct.convert_sd_text_encoder(sd, c.text.layers))):
            params.update({f"{rf.LDM}/{name}/{k}": v for k, v in tree.items()})
        params.update({f"clip/{k}": v for k, v in tct.convert_open_clip(
            _np(rf.open_clip_state_dict(model.clip)), tc.layers, vc.layers).items()})
        tp, ts = tcx.convert_xmask3d_checkpoint(
            _np(rf.released_checkpoint(rf.xmask3d_state_dict(model))["state_dict"]),
            arch_3d="MinkUNet18A", arch_binary="MinkUNet18A", dec_layers=2)
        params.update(tp)
        npz = tmp_path / f"seed{seed}.npz"
        np.savez(npz, **{f"params/{k}": v for k, v in params.items()},
                 **{f"batch_stats/{k}": v for k, v in ts.items()})
        summaries[seed] = infer_cli.main(argv + ["--converted", str(npz)] + tail, device="cpu")
    keys = [k for k in summaries["plain"] if k != "scenes_per_sec"]
    assert all(np.isfinite(summaries[3][k]) for k in keys)
    assert [summaries[0][k] for k in keys] == [summaries["plain"][k] for k in keys]
    assert [summaries[3][k] for k in keys] != [summaries["plain"][k] for k in keys]
