"""The port's brick-dense conv (`xmask3d_tpu_torch/ops/brick_conv.py`,
`XMASK3D_BRICK=1`) against the JAX package's, and against the port's own
gather-table path.

- `brick_metadata` through `build_hierarchy(..., brick_divisor=8)` (both
  host builders) against the JAX builder on a synthetic room surface:
  exact.
- `to_brick`, `brick_halo` (r = 1, 2), `brick_conv` at k3 and k5 and
  `from_brick` against the JAX functions on the same arrays: fp32 within
  1e-5 of max(1, |value|); a -1 slot is dropped, not wrapped.
- The port's tiny MinkUNet and the tiny model's `run_3d` with bricks on
  against bricks off on the same hierarchy, the JAX test's rule
  (`tests/test_brick_conv.py`): within 2e-3, every voxel kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu.data.synthetic import _room_surface_points
from xmask3d_tpu.data.voxelizer import Voxelizer as JaxVoxelizer
from xmask3d_tpu.ops import brick_conv as jbc
from xmask3d_tpu.ops.sparse_conv import build_hierarchy as jax_build_hierarchy
from xmask3d_tpu_torch.ops import brick_conv as bc
from xmask3d_tpu_torch.ops.sparse_conv import build_hierarchy, stack_hierarchies

TOL = 1e-5
NET_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coords(seed=0, cap=512):
    pts = _room_surface_points(np.random.RandomState(seed), 6000, room=(1.5, 1.5, 1.2))
    coords, _, _, _ = JaxVoxelizer(voxel_size=0.05).voxelize(pts, np.ones((len(pts), 3)), None)
    return coords[:cap], [cap, cap // 2, cap // 4, cap // 8, cap // 16]


@pytest.fixture(scope="module")
def hierarchies():
    coords, caps = _coords()
    want = jax_build_hierarchy(coords, caps, brick_divisor=8)
    return want, {b: build_hierarchy(coords, caps, builder=b, brick_divisor=8)
                  for b in ("native", "numpy")}


def test_brick_metadata_equals_jax(hierarchies):
    want, got = hierarchies
    for builder, h in got.items():
        for lv, (w, (nbr27, sor, sv)) in enumerate(zip(want.levels, h.bricks)):
            for name, a, b in (("nbr27", nbr27, w.nbr27), ("slot_of_rank", sor, w.slot_of_rank),
                               ("slot_valid", sv, w.slot_valid)):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{builder} {lv} {name}")
        assert (h.bricks[0][1][:h.num[0]] >= 0).all(), "the fixture dropped voxels"
    assert build_hierarchy(*_coords()).bricks is None
    st = stack_hierarchies([got["native"]])
    assert st.levels[2].nbr27.shape == (1, 27, 16) and st.levels[0].slot_valid.dtype == torch.bool


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=msg)


@pytest.mark.parametrize("kernel", [3, 5])
def test_brick_ops_equal_jax(hierarchies, kernel):
    want_h, got = hierarchies
    lv = want_h.levels[0]
    nbr27, sor, sv = (torch.from_numpy(a)[None] for a in got["native"].bricks[0])
    rng = np.random.RandomState(kernel)
    cin, cout = 8, 16
    feats = rng.randn(1, lv.valid.shape[0], cin).astype(np.float32)
    feats[0, ~lv.valid] = 0.0
    k = kernel ** 3
    w = (rng.randn(k, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    jsor, jnbr, jsv = (jnp.asarray(np.asarray(a))[None]
                       for a in (lv.slot_of_rank, lv.nbr27, lv.slot_valid))

    jb = jbc.to_brick(jnp.asarray(feats), jsor, lv.slot_valid.shape[0])
    tb = bc.to_brick(torch.from_numpy(feats), sor, sv.shape[-1])
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    r = kernel // 2
    _close(bc.brick_halo(tb, nbr27, r), jbc.brick_halo(jb, jnbr, r), "halo")
    jout = jbc.brick_conv(jb, jnp.asarray(w), jnbr, slot_valid=jsv, bias=jnp.asarray(bias))
    tout = bc.brick_conv(tb, torch.from_numpy(w), nbr27, slot_valid=sv,
                         bias=torch.from_numpy(bias))
    _close(tout, jout, "brick_conv")
    np.testing.assert_array_equal(bc.from_brick(tout, sor).numpy(),
                                  np.asarray(jbc.from_brick(jnp.asarray(tout.numpy()), jsor)))


def test_to_brick_drops_negative_slots():
    feats = torch.tensor([[[1.0] * 3, [2.0] * 3, [9.9] * 3]])
    out = bc.to_brick(feats, torch.tensor([[0, 127, -1]], dtype=torch.int32), 128)
    assert out.shape == (1, 128, 3)
    assert out[0, 0].tolist() == [1.0] * 3 and out[0, 127].tolist() == [2.0] * 3
    assert int((out.abs().sum(-1) > 0).sum()) == 2


def _net_hierarchy(cap=1024):
    coords, caps = _coords(seed=6, cap=cap)
    h = build_hierarchy(coords, caps, brick_divisor=8)
    for lv, (_, sor, _) in enumerate(h.bricks):
        assert (sor[:h.num[lv]] >= 0).all(), "the fixture dropped voxels"
    return stack_hierarchies([h])


def test_minkunet_brick_path_matches_its_gather_path(monkeypatch):
    from xmask3d_tpu_torch.models.minkunet import mink_unet

    h = _net_hierarchy()
    torch.manual_seed(0)
    net = mink_unet(out_channels=16, arch="MinkUNet14A").eval()
    feats = torch.from_numpy(np.random.RandomState(7).randn(1, 1024, 3).astype(np.float32))
    with torch.no_grad():
        monkeypatch.setenv("XMASK3D_BRICK", "0")
        want = net(feats, h)
        monkeypatch.setenv("XMASK3D_BRICK", "1")
        got = net(feats, h)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=NET_TOL, atol=NET_TOL)


def test_run_3d_with_bricks_matches_the_fused_stem_path(monkeypatch):
    """The tiny model's 3D branch: under XMASK3D_BRICK=1 each UNet runs its
    own stem brick-dense (no fused stem), and its outputs equal the default
    path's on the same hierarchy."""
    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine.builder import build_model
    from xmask3d_tpu_torch.ops import sparse_conv as sc

    cfg = load_config("configs/scannet/xmask3d_scannet_B15N4.yaml")
    cfg.update({"compute_dtype": "float32", "arch_3d": "MinkUNet14A", "mask_shape": [24, 32]})
    model = build_model(cfg, tiny=True, device="cpu")
    caps = Capacities(512, 256, 8)
    batch = synthetic_batch(1, caps, seed=0, num_points=400, image_size=(64, 64),
                            mask_shape=(24, 32), context_length=16, vocab_size=512, device="cpu")
    lv0 = batch["hierarchy"].levels[0]
    coords = lv0.coords[0, :int(lv0.num[0])].numpy()
    # synthetic views are sparse: one brick a voxel at most (divisor 1) keeps them all
    h = build_hierarchy(coords, caps.level_caps(), brick_divisor=1)
    assert all((sor[:n] >= 0).all() for (_, sor, _), n in zip(h.bricks, h.num))
    batch["hierarchy"] = stack_hierarchies([h])
    stems = []
    real = sc.sparse_conv

    def counting(x, w, kmap, **kw):
        stems.append(w.shape[0])
        return real(x, w, kmap, **kw)

    monkeypatch.setattr("xmask3d_tpu_torch.models.xmask3d.sparse_conv", counting)
    with torch.no_grad():
        monkeypatch.setenv("XMASK3D_BRICK", "0")
        want = model.run_3d(batch)
        monkeypatch.setenv("XMASK3D_BRICK", "1")
        got = model.run_3d(batch)
    assert stems == [125]  # the fused stem ran once, with bricks off only
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=NET_TOL, atol=NET_TOL, msg=k)
