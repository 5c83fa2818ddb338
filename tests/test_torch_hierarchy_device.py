"""The hierarchy built on the device (`ops/hierarchy_device.py`) against the
JAX package's `build_hierarchy_on_device` and the host builders.

- Every leaf equals the JAX device builder's bit for bit (the same
  sorted-key order at levels 1-4), on random, wide, edge and overflowing
  coordinate sets, batched with different counts.
- Level 0 (coords, validity, kmap3, kmap5) equals the host builders';
  deeper levels hold the same voxel sets in another row order, and the
  host hierarchy put in that order (`to_key_order`) equals the device
  builder's, every leaf.
- The reduced tiny model's eval outputs on a `device_hierarchy` batch
  against the host-built batch: discrete outputs exact, floats within
  rtol = atol = 2e-4 (the tolerance of the JAX package's
  `test_unet_output_equal_under_both_builders`).
- That batch through the port's view body against the JAX view body on the
  JAX package's `device_hierarchy` batch of the same seed (weights carried
  by `load_jax_variables`): the vote tables exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import random_variables
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.data.batching import Capacities as JaxCapacities
from xmask3d_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from xmask3d_tpu.engine import serve as jserve
from xmask3d_tpu.engine.builder import data_tokenizer, model_config_from_cfg, zero_statics
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu.ops.hierarchy_device import build_hierarchy_on_device as jax_device_build
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine import serve
from xmask3d_tpu_torch.engine.builder import build_model
from xmask3d_tpu_torch.engine.graphs import flatten
from xmask3d_tpu_torch.ops.hierarchy_device import build_hierarchy_on_device, to_key_order
from xmask3d_tpu_torch.ops.sparse_conv import build_hierarchy, stack_hierarchies

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
REDUCED = {"arch_3d": "MinkUNet14A", "arch_binary_head": "MinkUNet14A", "mask_shape": [24, 32],
           "compute_dtype": "float32", "max_points": 512, "max_voxels": 256, "max_targets": 8,
           "dec_layers": 2, "pixel_enc_layers": 2}
SMALL = dict(num_points=400, image_size=(64, 64), mask_shape=(24, 32), context_length=16,
             vocab_size=512)
CAPS = Capacities(max_points=512, max_voxels=256, max_targets=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unique(seed, n, hi):
    rng = np.random.RandomState(seed)
    return np.unique(rng.randint(0, hi, (n, 3)).astype(np.int32), axis=0)


def _edges():
    vals = np.array([0, 1, 1022, 1023], np.int32)
    return np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 3)


SETS = {
    "small": ([_unique(0, 180, 14), _unique(1, 120, 14)], (256, 256, 128, 64, 32)),
    "wide_and_edges": ([_unique(2, 300, 1024), _edges()], (512, 256, 128, 64, 32)),
    # every level past level 0 overflows its capacity
    "overflow": ([_unique(3, 900, 30)[:256], _unique(4, 60, 6)], (256, 64, 24, 16, 16)),
}


def _stage(cs, cap0):
    coords = np.zeros((len(cs), cap0, 3), np.int32)
    num = np.zeros((len(cs),), np.int32)
    for i, c in enumerate(cs):
        coords[i, : len(c)] = c[:cap0]
        num[i] = min(len(c), cap0)
    return coords, num


def _port_leaves(h):
    out = []
    for lv in h.levels:
        out += [lv.coords, lv.valid, lv.kmap3, lv.num]
    return out + list(h.down) + list(h.up_parent) + list(h.up_octant) + [h.kmap5]


@pytest.mark.parametrize("name", sorted(SETS))
def test_device_builder_equals_the_jax_device_builder(name):
    cs, caps = SETS[name]
    coords, num = _stage(cs, caps[0])
    got = _port_leaves(build_hierarchy_on_device(torch.from_numpy(coords),
                                                 torch.from_numpy(num), caps))
    want = _port_leaves(jax_device_build(jnp.asarray(coords), jnp.asarray(num), caps))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))


@pytest.mark.parametrize("name", sorted(SETS))
def test_level_zero_equals_the_host_builders(name):
    cs, caps = SETS[name]
    coords, num = _stage(cs, caps[0])
    h = build_hierarchy_on_device(torch.from_numpy(coords), torch.from_numpy(num), caps)
    for b, c in enumerate(cs):
        for builder in ("native", "numpy"):
            host = build_hierarchy(c, caps, builder=builder)
            np.testing.assert_array_equal(h.levels[0].coords[b].numpy(), host.coords[0])
            np.testing.assert_array_equal(h.levels[0].valid[b].numpy(), host.valid[0])
            np.testing.assert_array_equal(h.levels[0].kmap3[b].numpy(), host.kmap3[0])
            np.testing.assert_array_equal(h.kmap5[b].numpy(), host.kmap5)
            np.testing.assert_array_equal(h.up_octant[0][b].numpy(), host.up_octant[0])
        # the same voxels at each level up to the first that overflows its
        # capacity: there the host keeps the first-occurring parents and
        # the device the smallest keys
        for lv in range(1, len(caps)):
            n = int(h.levels[lv].num[b])
            assert n == host.num[lv]
            if n == caps[lv]:
                break
            got = {tuple(r) for r in h.levels[lv].coords[b][:n].tolist()}
            assert got == {tuple(r) for r in host.coords[lv][:n].tolist()}


def test_host_hierarchy_in_key_order_equals_the_device_builders():
    """`to_key_order` of the host builders' stacked hierarchy is the device
    builder's, every leaf, where no level overflows its capacity."""
    caps = (512,) * 5
    for name in ("small", "wide_and_edges"):
        cs = SETS[name][0]
        coords, num = _stage(cs, caps[0])
        host = stack_hierarchies([build_hierarchy(c, caps) for c in cs])
        assert all(int(n) < c for lv, c in zip(host.levels[1:], caps[1:]) for n in lv.num)
        (sd, ld), (sk, lk) = (
            flatten(build_hierarchy_on_device(torch.from_numpy(coords), torch.from_numpy(num),
                                              caps)),
            flatten(to_key_order(host)))
        assert sd == sk and all(torch.equal(a, b) for a, b in zip(ld, lk)), name
        # level 0 and every count as they were
        assert torch.equal(to_key_order(host).levels[0].kmap3, host.levels[0].kmap3)


def _tiny_model():
    cfg = load_config(CONFIG)
    cfg.update(REDUCED)
    return cfg, build_model(cfg, tiny=True, seed=3, device="cpu")


def test_eval_outputs_equal_under_both_builders():
    """At capacities no level fills (the views' ~400 voxels in 4096 rows):
    where a level overflows, the host builders keep its first-occurring
    voxels and the device builder its smallest keys, as in the JAX package,
    and the two models see different voxels."""
    from xmask3d_tpu_torch.engine.builder import build_statics

    cfg, model = _tiny_model()
    statics = build_statics(model, cfg, device="cpu")
    caps = Capacities(max_points=512, max_voxels=4096, max_targets=8)
    for seed in (5, 6):
        host = synthetic_batch(1, caps, seed=seed, device="cpu", **SMALL)
        dev = synthetic_batch(1, caps, seed=seed, device="cpu", device_hierarchy=True, **SMALL)
        assert "hierarchy" not in dev and set(host) - {"hierarchy"} == \
            set(dev) - {"voxel_coords", "voxel_num"}
        assert all(int(lv.num[0]) < cap for lv, cap in zip(host["hierarchy"].levels,
                                                             caps.level_caps()))
        with torch.no_grad():
            want = model.eval_forward(host, statics)
            got = model.eval_forward(dev, statics)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            if not torch.is_tensor(w):
                continue
            if w.is_floating_point():
                torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4, msg=k)
            else:
                assert torch.equal(g, w), k


@pytest.fixture(scope="module")
def jax_tiny():
    jcfg = jax_load_config(CONFIG)
    jcfg.update(REDUCED)
    caps = JaxCapacities(max_points=512, max_voxels=256, max_targets=8)
    batch0 = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(
        1, caps, seed=0, num_classes=jcfg.classes, **SMALL))
    model = JaxXMask3D(cfg=model_config_from_cfg(jcfg, tiny=True))
    rngs = {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(partial(model.init, train=True), rngs, batch0,
                            zero_statics(model, jcfg))
    variables = random_variables({"params": shapes["params"],
                                  "batch_stats": shapes["batch_stats"]}, seed=12)
    tok = data_tokenizer(jcfg, tiny=True)
    bank = jax.jit(lambda v, t: model.apply(v, t, method=lambda m, x: m.embed_captions(x)))
    statics = {"text_embed_train": bank(variables, jnp.asarray(tok(list(jcfg.label)))),
               "text_embed_test": bank(variables, jnp.asarray(tok(list(jcfg.all_label)))),
               "uncond_tokens": jnp.asarray(tok([""]))}
    pcfg = load_config(CONFIG)
    pcfg.update(REDUCED)
    port = build_model(pcfg, tiny=True, device="cpu")
    load_jax_variables(port, jax.device_get(variables))
    return {"jcfg": jcfg, "pcfg": pcfg, "caps": caps, "model": model, "variables": variables,
            "statics": statics, "port": port}


def test_view_body_on_a_device_hierarchy_equals_jax(jax_tiny):
    """The same seed's `device_hierarchy` batch through the port's view body
    and the JAX package's (which builds its hierarchy inside the jit): equal
    batches and equal vote tables."""
    t = jax_tiny
    jbatch = jax_synthetic_batch(1, t["caps"], seed=9, num_classes=t["jcfg"].classes,
                                 device_hierarchy=True, **SMALL)
    batch = synthetic_batch(1, CAPS, seed=9, num_classes=t["jcfg"].classes, device="cpu",
                            device_hierarchy=True, **SMALL)
    assert set(batch) == set(jbatch)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)
    body = jax.jit(jserve.make_view_body(t["model"], t["jcfg"]))
    want = jax.device_get(body(t["variables"], jax.tree_util.tree_map(jnp.asarray, jbatch),
                               t["statics"], *jserve.fresh_vote_state(512, 19)))
    pstatics = {k: torch.from_numpy(np.array(v)) for k, v in t["statics"].items()}
    got = serve.make_view_body(t["port"], t["pcfg"], device="cpu")(
        batch, pstatics, *serve.fresh_vote_state(512, 19, device="cpu"))
    assert int(got[1].sum()) == int(batch["point_valid"].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert flatten(batch)[0] == flatten(synthetic_batch(1, CAPS, seed=9, device="cpu",
                                                        device_hierarchy=True, **SMALL))[0]
