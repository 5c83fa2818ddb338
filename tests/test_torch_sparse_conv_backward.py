"""K1's backward in its gather form, on the CPU: the map identities it rests
on, for both host builders and the device builder, its plain statement
against the plain VJP, and which form the model's calls take.

A call that carries its map's transpose (`sparse_conv(..., transpose=)`)
takes the gather form: the feature gradient through the transposed map
(same-level maps: tap K-1-k; a down map: `down_transposes`), the weight
gradient as gathered products. On the card that is the `k1_dgrad_*` and
`k1_wgrad_*` kernels (`tests/test_torch_kernels_gpu.py`); here it is
`sparse_conv_backward_reference`, which must equal the plain VJP in fp32 up
to summation order (1e-5 of the gradient's largest value).
"""

import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.models import minkunet
from xmask3d_tpu_torch.ops import _build
from xmask3d_tpu_torch.ops import sparse_conv as tsc
from xmask3d_tpu_torch.ops.hierarchy_device import build_hierarchy_on_device

TOL = 1e-5


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
    vals = np.array([0, 1, 2, 1021, 1022, 1023], np.int32)
    return np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 3)


SETS = {
    "small": ([_unique(0, 180, 14), _unique(1, 120, 14)], (256, 256, 128, 64, 32)),
    "wide_and_edges": ([_unique(2, 300, 1024), _edges()], (512, 256, 128, 64, 32)),
    # every level past level 0 overflows its capacity, and level 0 its own
    "overflow": ([_unique(3, 900, 30), _unique(4, 60, 6)], (256, 64, 24, 16, 16)),
}
BUILDERS = ("native", "numpy", "device")


def _hierarchy(name, builder):
    cs, caps = SETS[name]
    if builder != "device":
        return tsc.stack_hierarchies([tsc.build_hierarchy(c, caps, builder=builder) for c in cs])
    coords = np.zeros((len(cs), caps[0], 3), np.int32)
    num = np.zeros((len(cs),), np.int32)
    for i, c in enumerate(cs):
        coords[i, : min(len(c), caps[0])] = c[: caps[0]]
        num[i] = min(len(c), caps[0])
    return build_hierarchy_on_device(torch.from_numpy(coords), torch.from_numpy(num), caps)


def _assert_transposes(m, m_t, n_in):
    """m_t[b, k] is m[b, k]'s transpose: every pair (v, u = m[b, k, v]) is a
    pair (u, v) of m_t[b, k] and the two hold as many pairs (so a tap hits an
    input row once at most)."""
    m, m_t = m.numpy(), m_t.numpy()
    assert m.shape[:2] == m_t.shape[:2] and m_t.shape[2] == n_in
    pairs = 0
    for b in range(m.shape[0]):
        for k in range(m.shape[1]):
            v = np.nonzero(m[b, k] >= 0)[0]
            u = m[b, k, v]
            assert np.array_equal(m_t[b, k, u], v), (b, k)
            assert len(v) == int((m_t[b, k] >= 0).sum()), (b, k)
            pairs += len(v)
    assert pairs > 0


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_same_level_maps_transpose_through_the_flipped_tap(name, builder):
    """kmap[K-1-k] is kmap[k]'s transpose on every level's kmap3 and on
    kmap5, so the feature gradient of a same-level call needs no new map."""
    h = _hierarchy(name, builder)
    for m in [lv.kmap3 for lv in h.levels] + [h.kmap5]:
        _assert_transposes(m, m.flip(1), m.shape[2])


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_down_transposes_invert_the_down_maps(name, builder):
    """down_t[s] (each voxel's one parent through its octant) transposes
    down[s], also where level s + 1 is cut by its capacity (the children of
    a dropped parent have none)."""
    h = _hierarchy(name, builder)
    down_t = tsc.down_transposes(h)
    assert len(down_t) == len(h.down)
    for s, (m, m_t) in enumerate(zip(h.down, down_t)):
        assert m_t.dtype == torch.int32 and m_t.is_contiguous()
        _assert_transposes(m, m_t, h.levels[s].valid.shape[1])


def test_down_transposes_are_kept_until_their_inputs_change():
    h = _hierarchy("small", "numpy")
    first = tsc.down_transposes(h)
    assert tsc.down_transposes(h) is first
    h.up_octant[1][0, 0] = (h.up_octant[1][0, 0] + 1) % 8  # written in place
    again = tsc.down_transposes(h)
    assert again is not first and not torch.equal(again[1], first[1])
    assert all(torch.equal(a, b) for a, b in zip(again[:1] + again[2:], first[:1] + first[2:]))


# (map, transpose, feature rows, output mask) of each kind of call the
# model makes: a level's kmap3, the k5 stem and a down map
def _calls(h):
    lv, down_t = h.levels, tsc.down_transposes(h)
    return {"kmap3": (lv[0].kmap3, tsc.SAME_LEVEL, lv[0].valid.shape[1], lv[0].valid),
            "kmap3_deep": (lv[2].kmap3, tsc.SAME_LEVEL, lv[2].valid.shape[1], lv[2].valid),
            "kmap5": (h.kmap5, tsc.SAME_LEVEL, lv[0].valid.shape[1], lv[0].valid),
            "down": (h.down[1], down_t[1], lv[1].valid.shape[1], lv[2].valid)}


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("kind", ["kmap3", "kmap3_deep", "kmap5", "down"])
def test_gather_form_equals_the_plain_vjp(kind, masked):
    """fp32, B = 2: feats, weights and bias; with and without out_valid (the
    cotangent's rows outside it count as zero)."""
    h = _hierarchy("small", "native")
    kmap, transpose, v_in, valid = _calls(h)[kind]
    valid = valid if masked else None
    gen = torch.Generator().manual_seed(len(kind))
    k, ci, co = kmap.shape[1], 6, 5
    feats = torch.randn(2, v_in, ci, generator=gen)
    w = torch.randn(k, ci, co, generator=gen) / 4
    bias = torch.randn(co, generator=gen)
    g = torch.randn(2, kmap.shape[2], co, generator=gen)
    got = tsc.sparse_conv_backward_reference(g, feats, w, kmap, transpose, bias, valid)
    want = _build.plain_vjp(lambda f, wt, b: tsc.sparse_conv_reference(f, wt, kmap, b, valid),
                            (feats, w, bias), (True, True, True), g)
    for what, x, y in zip(("feats", "weights", "bias"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, what
        err = float((x - y).abs().max())
        assert err <= TOL * max(1.0, float(y.abs().max())), (what, err)


def test_gather_form_without_the_feature_gradient():
    """The stem's colours take no gradient: only dW (and db) are formed."""
    h = _hierarchy("small", "numpy")
    kmap, transpose, v_in, valid = _calls(h)["kmap5"]
    gen = torch.Generator().manual_seed(5)
    feats = torch.randn(2, v_in, 3, generator=gen)
    w = torch.randn(125, 3, 8, generator=gen) / 8
    g = torch.randn(2, kmap.shape[2], 8, generator=gen)
    df, dw, db = tsc.sparse_conv_backward_reference(g, feats, w, kmap, transpose, None, valid,
                                                    (False, True, False))
    assert df is None and db is None
    want = _build.plain_vjp(lambda wt: tsc.sparse_conv_reference(feats, wt, kmap, None, valid),
                            (w,), (True,), g)[0]
    assert float((dw - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_call_with_its_transpose_takes_the_gather_form(dtype):
    """Through the autograd Function: the form is counted, the recorder and
    the launch counter see the forward only, and the gradients are the
    plain statement's (bf16: cast once from fp32)."""
    h = _hierarchy("small", "native")
    kmap, transpose, v_in, valid = _calls(h)["down"]
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(2, v_in, 8, generator=gen).to(dtype).requires_grad_()
    w = (torch.randn(8, 8, 16, generator=gen) / 4).to(dtype).requires_grad_()
    g = torch.randn(2, kmap.shape[2], 16, generator=gen).to(dtype)
    seen = []
    before = dict(tsc.sparse_conv.backward_calls)
    _build.RECORDER = lambda name, args: seen.append(name)
    try:
        tsc.sparse_conv(feats, w, kmap, out_valid=valid, transpose=transpose).backward(g)
        feats2, w2 = (x.detach().clone().requires_grad_() for x in (feats, w))
        tsc.sparse_conv(feats2, w2, kmap, out_valid=valid).backward(g)
    finally:
        _build.RECORDER = None
    assert seen == ["sparse_conv", "sparse_conv"]
    assert tsc.sparse_conv.backward_calls == {"kernel": before["kernel"] + 1,
                                              "plain": before["plain"] + 1}
    df, dw, _ = tsc.sparse_conv_backward_reference(g, feats.detach(), w.detach(), kmap, transpose,
                                                   None, valid)
    assert torch.equal(feats.grad, df) and torch.equal(w.grad, dw)
    assert feats.grad.dtype == dtype and w.grad.dtype == dtype
    if dtype == torch.float32:  # the plain VJP: equal up to summation order
        for x, y in ((feats.grad, feats2.grad), (w.grad, w2.grad)):
            assert float((x - y).abs().max()) <= TOL * max(1.0, float(y.abs().max()))


def test_sparse_conv_refuses_a_transpose_it_cannot_use():
    h = _hierarchy("wide_and_edges", "numpy")  # levels 0 and 1 of different capacities
    feats, w = torch.zeros(2, h.levels[0].valid.shape[1], 4), torch.zeros(8, 4, 4)
    down_t = tsc.down_transposes(h)
    with pytest.raises(ValueError, match="SAME_LEVEL"):  # a down map is not same-level
        tsc.sparse_conv(feats, w, h.down[0], transpose=tsc.SAME_LEVEL)
    with pytest.raises(ValueError, match="SAME_LEVEL"):
        tsc.sparse_conv(feats, w, h.down[0], transpose="flip")
    for bad in (down_t[1], down_t[0].long(), down_t[0][:, :, ::2]):
        with pytest.raises(ValueError, match="transpose"):
            tsc.sparse_conv(feats, w, h.down[0], transpose=bad)


@pytest.mark.parametrize("bricks", [False, True])
def test_minkunet_training_backward_takes_the_gather_form_on_every_k1_call(bricks, monkeypatch):
    """A MinkUNet in training mode, forward and backward: every K1 call of
    the net (the k5 stem, the down convs, two k3 convs a residual block; with
    bricks only the down convs are K1 calls) takes the gather form, none the
    plain VJP."""
    monkeypatch.setenv("XMASK3D_BRICK", "1" if bricks else "0")
    cs, caps = SETS["small"]
    h = tsc.stack_hierarchies([tsc.build_hierarchy(c, caps, brick_divisor=2 if bricks else 0)
                               for c in cs])
    torch.manual_seed(0)
    net = minkunet.mink_unet(out_channels=8, arch="MinkUNet14A")
    feats = torch.randn(2, caps[0], 3)
    seen = []
    before = dict(tsc.sparse_conv.backward_calls)
    _build.RECORDER = lambda name, args: seen.append(name)
    try:
        bottleneck, out = net(feats, h)
        (out.square().mean() + bottleneck.mean()).backward()
    finally:
        _build.RECORDER = None
    calls = seen.count("sparse_conv")
    assert calls == (4 if bricks else 1 + 4 + 2 * sum(net.layers))
    assert tsc.sparse_conv.backward_calls == {"kernel": before["kernel"] + calls,
                                              "plain": before["plain"]}
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in net.parameters() if p.requires_grad)
