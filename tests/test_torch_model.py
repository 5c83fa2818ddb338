"""The port's slice, step by step and end to end, against the JAX package.

One tiny configuration (MinkUNet14A for both 3D nets, ViT-tiny, LDM_TINY,
mask shape (24, 32), capacities 512/256/8, float32 on both sides) with
every JAX leaf drawn from a numpy seed (non-zero conditioning gates and
deformable offsets included) and carried into the port by
`load_jax_variables`. The image is 128x128; a second case runs the stages at
64x64, where the tiny UNet's innermost map is 1x1 and its GroupNorms see two
values per group (the port computes GroupNorm as flax does, one-pass
variance included, so the two agree there too). The JAX side runs once per
image size: one jitted eval forward that also records each step's output.
Each step of the port is then fed the JAX inputs of that step, so a
divergence is pinned to its step.

Tolerances: 1e-4 of each output's largest value per step (fp32 in both
frameworks, op order differs); the eval golden's rtol = atol = 2e-3 for the
whole eval forward; masks, labels and votes exact except where the JAX
decision lies within 1e-4 of its threshold (counted and reported).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.engine.builder import data_tokenizer, model_config_from_cfg, zero_statics
from xmask3d_tpu.engine.infer import ensemble_and_route as jax_ensemble_and_route
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.engine.builder import build_model, build_statics
from xmask3d_tpu_torch.engine.infer import device_vote_add, ensemble_and_route
from xmask3d_tpu_torch.engine.serve import fresh_vote_state, make_view_body
from xmask3d_tpu_torch.ops.sparse_conv import SparseHierarchy, SparseLevel

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
TINY = {"arch_3d": "MinkUNet14A", "arch_binary_head": "MinkUNet14A",
        "mask_shape": [24, 32], "compute_dtype": "float32",
        "max_points": 512, "max_voxels": 256, "max_targets": 8}
STEP_TOL = 1e-4
E2E_TOL = 2e-3
NEAR = 1e-4
IMAGE = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(loader):
    cfg = loader(CONFIG)
    cfg.update(TINY)
    return cfg


def random_variables(shapes, seed=0):
    """Every leaf drawn from a numpy seed: kernels at their fan-in scale
    (He for the sparse kernels), norm scales near 1, biases, running stats,
    embeddings, conditioning gates and the shared noise all non-trivial."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        last = name.rsplit("/", 1)[-1]
        shape = leaf.shape
        if last == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        if last == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif last == "scale":
            x = 1.0 + 0.1 * rng.randn(*shape)
        elif last in ("bias", "mean"):
            x = 0.1 * rng.randn(*shape)
        elif last == "kernel" and len(shape) == 3:  # sparse (K, C_in, C_out)
            x = rng.randn(*shape) * np.sqrt(2.0 / (shape[0] * shape[1]))
        elif last == "kernel":
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif last in ("shared_noise", "query_feat", "query_embed", "level_embed") \
                or last.startswith("level_embed_"):
            x = rng.randn(*shape)
        elif last.startswith("alpha_cond"):
            x = 0.5 * rng.randn(*shape)
        else:
            x = 0.1 * rng.randn(*shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def to_port_batch(batch):
    """The JAX package's numpy batch as the port's batch of CPU tensors."""
    h = batch["hierarchy"]

    def t(a):
        return torch.from_numpy(np.asarray(a))

    out = {k: t(v) for k, v in batch.items() if k != "hierarchy"}
    out["hierarchy"] = SparseHierarchy(
        levels=tuple(SparseLevel(t(l.coords), t(l.valid), t(l.kmap3), t(l.num)) for l in h.levels),
        down=tuple(t(x) for x in h.down), up_parent=tuple(t(x) for x in h.up_parent),
        up_octant=tuple(t(x) for x in h.up_octant), kmap5=t(h.kmap5),
    )
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def assert_close(got, want, tol, what):
    """max |got - want| within `tol` of want's largest value."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale + 1e-7, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


def assert_golden(got, want, what):
    """The eval golden's elementwise rtol = atol = 2e-3."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=E2E_TOL, atol=E2E_TOL, err_msg=what)


def _tt(x):
    return torch.from_numpy(np.array(x))


def _both(image):
    jcfg = _tiny_cfg(jax_load_config)
    caps = JaxCapacities(max_points=512, max_voxels=256, max_targets=8)
    batch_np = jax_synthetic_batch(
        1, caps, seed=0, num_points=400, image_size=(image, image), mask_shape=(24, 32),
        context_length=16, vocab_size=512,
    )
    batch = jax.tree_util.tree_map(jnp.asarray, batch_np)
    mc = model_config_from_cfg(jcfg, tiny=True)
    assert mc.dtype == jnp.float32 and mc.arch_3d == "MinkUNet14A"
    model = JaxXMask3D(cfg=mc)
    rngs = {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(partial(model.init, train=True), rngs, batch,
                            zero_statics(model, jcfg))
    variables = random_variables(
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})

    @jax.jit
    def text_bank(v, toks):
        return model.apply(v, toks, method=lambda m, t: m.embed_captions(t))

    tok = data_tokenizer(jcfg, tiny=True)
    statics = {
        "text_embed_train": text_bank(variables, jnp.asarray(tok(list(jcfg.label)))),
        "text_embed_test": text_bank(variables, jnp.asarray(tok(list(jcfg.all_label)))),
        "uncond_tokens": jnp.asarray(tok([""])),
    }

    keep = {"run_3d", "_clip_mask_embed"}

    @jax.jit
    def forward(v, b, st):
        (_, out), inter = model.apply(
            v, b, st, train=False, capture_intermediates=lambda m, n: n in keep
            or (n == "__call__" and m.name in ("backbone", "feature_extractor",
                                               "pixel_decoder", "mask_decoder")),
            mutable=["intermediates"],
        )
        routed = jax_ensemble_and_route(
            out, mc.base_category, mc.novel_category, mc.num_test_classes,
            jcfg.base_ratio, jcfg.novel_ratio,
        )
        return out, inter["intermediates"], routed

    out, inter, routed = jax.device_get(forward(variables, batch, statics))

    pcfg = _tiny_cfg(load_config)
    port = build_model(pcfg, tiny=True, device="cpu")
    assert port.cfg.dtype == torch.float32
    load_jax_variables(port, jax.device_get(variables))
    return {
        "jcfg": jcfg, "pcfg": pcfg, "port": port, "batch": to_port_batch(batch_np),
        "batch_np": batch_np, "statics": {k: _tt(v) for k, v in statics.items()},
        "variables": variables, "out": out, "inter": inter, "routed": routed,
    }


@pytest.fixture(scope="module")
def both():
    return _both(IMAGE)


@pytest.fixture(scope="module")
def both64():
    return _both(64)


def test_weights_carried_leaf_by_leaf(both):
    """Every port tensor equals its JAX leaf under the bridge's rule."""
    params = both["variables"]["params"]
    sd = both["port"].state_dict()
    np.testing.assert_array_equal(
        sd["pc_decoder.MinkUNet_0.conv0.kernel"].numpy(),
        params["pc_decoder"]["MinkUNet_0"]["conv0"]["kernel"])
    blk = params["backbone"]["feature_extractor"]["ldm_extractor"]["unet"]["down_0_attn_0"]["block_0"]
    np.testing.assert_array_equal(
        sd["backbone.feature_extractor.ldm_extractor.unet.down_0_attn_0.block_0.attn1.to_k.weight"].numpy(),
        blk["attn1"]["to_k"]["kernel"].T)
    conv = params["backbone"]["proj_0"]["conv2"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.proj_0.conv2.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    bs = both["variables"]["batch_stats"]["pc_binary_head"]["bn"]
    np.testing.assert_array_equal(sd["pc_binary_head.bn.var"].numpy(), bs["var"])
    n_leaves = len(jax.tree_util.tree_leaves(both["variables"]))
    assert n_leaves == len(sd)


def test_statics_text_banks(both):
    st = build_statics(both["port"], both["pcfg"], device="cpu")
    for key in ("text_embed_train", "text_embed_test"):
        assert_close(st[key], both["statics"][key], STEP_TOL, key)
    np.testing.assert_array_equal(st["uncond_tokens"].numpy(), both["statics"]["uncond_tokens"].numpy())


def test_run_3d(both):
    """Both sparse UNets with the fused k5 stem."""
    got = both["port"].run_3d(both["batch"])
    want = both["inter"]["run_3d"][0]
    for key in ("imp_condition", "pred_3d", "binary_scores"):
        assert_close(got[key], want[key], STEP_TOL, key)


def test_backbone_taps_and_projections(both):
    """The LDM taps (VAE encoder, UNet, VAE decoder) and the s2..s5 maps, fed
    the JAX 3D conditioning."""
    b, port = both["batch"], both["port"]
    img01 = b["img"] / 255.0
    imp = _tt(both["inter"]["run_3d"][0]["imp_condition"])
    uncond = both["statics"]["uncond_tokens"]
    bb = both["inter"]["backbone"]
    with torch.no_grad():
        taps = port.backbone.feature_extractor(img01, imp, uncond)
        feats = port.backbone(img01, imp, uncond)
    want_taps = bb["feature_extractor"]["__call__"][0]
    assert len(taps) == len(want_taps) == 8
    for i, (g, w) in enumerate(zip(taps, want_taps)):
        assert_close(g, w, STEP_TOL, f"tap {i}")
    for name, w in bb["__call__"][0].items():
        assert_close(feats[name], w, STEP_TOL, name)


def test_pixel_decoder(both):
    feats = {k: _tt(v) for k, v in both["inter"]["backbone"]["__call__"][0].items()}
    with torch.no_grad():
        mf, ms = both["port"].pixel_decoder(feats)
    want_mf, want_ms = both["inter"]["pixel_decoder"]["__call__"][0]
    assert_close(mf, want_mf, STEP_TOL, "mask_features")
    for i, (g, w) in enumerate(zip(ms, want_ms)):
        assert_close(g, w, STEP_TOL, f"level {i}")


def test_mask_decoder(both):
    mf, ms = both["inter"]["pixel_decoder"]["__call__"][0]
    with torch.no_grad():
        got = both["port"].mask_decoder([_tt(m) for m in ms], _tt(mf))
    want = both["inter"]["mask_decoder"]["__call__"][0]
    for key in ("pred_masks", "mask_embed", "mask_pooled_features"):
        assert_close(got[key], want[key], STEP_TOL, key)
    assert_close(got["logit_scale"], want["logit_scale"], 1e-6, "logit_scale")
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 9
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        assert_close(g["pred_masks"], w["pred_masks"], STEP_TOL, f"aux {i} masks")


def test_maskclip_embeddings(both):
    img01 = both["batch"]["img"] / 255.0
    masks = _tt(both["inter"]["mask_decoder"]["__call__"][0]["pred_masks"])
    with torch.no_grad():
        got = both["port"]._clip_mask_embed(img01, masks)
    assert_close(got, both["inter"]["_clip_mask_embed"][0], STEP_TOL, "mask_embed_clip")


def _near_claim(masks, scores, keep):
    """Pixels whose panoptic claim (argmax over queries of score *
    sigmoid(mask)) or own 0.5 gate is within NEAR of flipping."""
    sig = 1 / (1 + np.exp(-masks.astype(np.float64)))
    prob = np.where(keep[:, :, None, None], scores[:, :, None, None] * sig, -1e30)
    top2 = np.sort(prob, axis=1)[:, -2:]
    near_claim = (top2[:, 1] - top2[:, 0]) < NEAR  # (B, H, W)
    return near_claim[:, None] | (np.abs(sig - 0.5) < NEAR)


def test_eval_forward_route_and_vote(both):
    """The whole eval forward + ensemble/routing + vote update: continuous
    outputs within 2e-3, discrete ones exact away from thresholds."""
    port, b, st = both["port"], both["batch"], both["statics"]
    out, routed = both["out"], both["routed"]
    got = port.eval_forward(b, st)
    for key in ("pred_logits", "mask_cls_results", "fused_pred_feature", "2d_pred_feature",
                "pure3d_pred_feature", "mask_embed_clip", "binary_sig", "pred_scores"):
        assert_golden(got[key], out[key], key)

    # discrete outputs: exact, save mask decisions within NEAR of a threshold
    mh, mw = both["jcfg"].mask_shape
    masks = np.asarray(jax.image.resize(out["pred_masks"], out["pred_masks"].shape[:2] + (mh, mw),
                              "bilinear", antialias=False))
    bnp = both["batch_np"]
    pv = bnp["point_valid"][0]
    near_pix = _near_claim(masks, out["pred_scores"], out["final_mask_valid"])
    rows = np.arange(1)[:, None]
    near = near_pix[rows, :, bnp["x_label"], bnp["y_label"]].transpose(0, 2, 1)  # (B, Q, P)
    diff_mask = _np(got["final_mask_3d"]) != out["final_mask_3d"]
    assert not (diff_mask & ~near).any(), "final_mask_3d differs away from a threshold"
    n_near = int(diff_mask.sum())
    for key in ("pred_labels", "final_mask_valid", "binary_pred", "covered"):
        np.testing.assert_array_equal(_np(got[key]), out[key], err_msg=key)

    mc = port.cfg
    cfg = both["pcfg"]
    r = ensemble_and_route(got, mc.base_category, mc.novel_category, mc.num_test_classes,
                           cfg.base_ratio, cfg.novel_ratio)
    # a point's vote may move only where one of its masks flipped at a threshold
    free = diff_mask.any(axis=1)[0]
    diff_pred = (_np(r["pred"])[0] != routed["pred"][0]) & pv
    assert not (diff_pred & ~free).any(), "votes differ where no mask flipped"
    np.testing.assert_array_equal(_np(r["pred_3d"]), routed["pred_3d"])

    # the view body's vote table against the JAX identity-id one-hot accumulate
    votes, counter = fresh_vote_state(512, mc.num_test_classes, device="cpu")
    view = make_view_body(port, cfg, device="cpu")
    votes, counter = view(b, st, votes, counter)
    want_votes = np.zeros((512, mc.num_test_classes), np.int32)
    want_votes[np.arange(512)[pv], routed["pred"][0][pv]] += 1
    assert (votes.numpy() != want_votes).any(axis=1).sum() == int(diff_pred.sum())
    np.testing.assert_array_equal(counter.numpy(), pv.astype(np.int32))
    print(f"near-threshold cases: final_mask_3d {n_near}, votes {int(diff_pred.sum())}")


def test_stages_at_64_image(both64):
    """The stage comparison at a 64x64 image: the LDM taps (two values per
    GroupNorm group at the UNet's 1x1 level), the s2..s5 maps, the pixel
    and mask decoders and MaskCLIP, each fed the JAX inputs of its step;
    then the eval forward's logits within the golden's tolerance."""
    b, port, inter = both64["batch"], both64["port"], both64["inter"]
    img01 = b["img"] / 255.0
    imp = _tt(inter["run_3d"][0]["imp_condition"])
    uncond = both64["statics"]["uncond_tokens"]
    bb = inter["backbone"]
    with torch.no_grad():
        taps = port.backbone.feature_extractor(img01, imp, uncond)
        feats = port.backbone(img01, imp, uncond)
        mf_want, ms_want = inter["pixel_decoder"]["__call__"][0]
        mf, ms = port.pixel_decoder({k: _tt(v) for k, v in bb["__call__"][0].items()})
        dec = port.mask_decoder([_tt(m) for m in ms_want], _tt(mf_want))
        masks = _tt(inter["mask_decoder"]["__call__"][0]["pred_masks"])
        clip = port._clip_mask_embed(img01, masks)
    assert feats["s5"].shape[1:3] == (2, 2)
    for i, (g, w) in enumerate(zip(taps, bb["feature_extractor"]["__call__"][0])):
        assert_close(g, w, STEP_TOL, f"tap {i}")
    for name, w in bb["__call__"][0].items():
        assert_close(feats[name], w, STEP_TOL, name)
    assert_close(mf, mf_want, STEP_TOL, "mask_features")
    for i, (g, w) in enumerate(zip(ms, ms_want)):
        assert_close(g, w, STEP_TOL, f"level {i}")
    want_dec = inter["mask_decoder"]["__call__"][0]
    for key in ("pred_masks", "mask_embed"):
        assert_close(dec[key], want_dec[key], STEP_TOL, key)
    assert_close(clip, inter["_clip_mask_embed"][0], STEP_TOL, "mask_embed_clip")
    got = port.eval_forward(b, both64["statics"])
    for key in ("pred_logits", "fused_pred_feature", "mask_embed_clip", "binary_sig"):
        assert_golden(got[key], both64["out"][key], key)


def test_device_vote_add_drops_invalid_rows():
    votes = torch.zeros((4, 3), dtype=torch.int32)
    counter = torch.zeros((4,), dtype=torch.int32)
    ids = torch.tensor([0, 1, -1, 7, 3, 3])
    preds = torch.tensor([2, 0, 1, 1, 1, 1])
    valid = torch.tensor([True, True, True, True, False, True])
    votes, counter = device_vote_add(votes, counter, ids, preds, valid)
    np.testing.assert_array_equal(votes.numpy(), [[0, 0, 1], [1, 0, 0], [0, 0, 0], [0, 1, 0]])
    np.testing.assert_array_equal(counter.numpy(), [1, 1, 0, 1])
