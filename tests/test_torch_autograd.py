"""Gradients through the port's four kernel wrappers, and MaskedBatchNorm's
training statistics, against the JAX package.

Each wrapper is a `torch.autograd.Function` whose backward is its plain
version's VJP, as each JAX kernel takes its backward from its XLA
formulation through `custom_vjp`. On the CPU the forward is the plain
version too, so these cases hold the Function's VJP against `jax.vjp` of
the JAX dispatchers (`sparse_conv_auto`, `attention`, `ms_deform_attn_auto`,
`gn_silu_conv`, which run their XLA formulations on the CPU) on the same
numpy inputs and cotangents: fp32, within 1e-4 of each gradient's largest
value. Cotangents are given as non-contiguous views, as autograd can pass
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu.models.minkunet import MaskedBatchNorm as JaxMaskedBatchNorm
from xmask3d_tpu.ops.deform_attn import ms_deform_attn_auto
from xmask3d_tpu.ops.flash_attention import attention as jax_attention
from xmask3d_tpu.ops.gn_conv import gn_silu_conv as jax_gn_silu_conv
from xmask3d_tpu.ops.sparse_conv_pallas import sparse_conv_auto
from xmask3d_tpu_torch.models.minkunet import MaskedBatchNorm
from xmask3d_tpu_torch.ops import _build
from xmask3d_tpu_torch.ops.deform_attn import ms_deform_attn
from xmask3d_tpu_torch.ops.flash_attention import attention
from xmask3d_tpu_torch.ops.gn_conv import gn_silu_conv, kernel_params
from xmask3d_tpu_torch.ops.sparse_conv import sparse_conv

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noncontig(a: np.ndarray) -> torch.Tensor:
    """`a` as a non-contiguous tensor view (every other row of a wider one)."""
    wide = np.zeros(a.shape[:-1] + (2 * a.shape[-1],), a.dtype)
    wide[..., ::2] = a
    t = torch.from_numpy(wide)[..., ::2]
    assert not t.is_contiguous()
    return t


def _vjp_port(fn, diff, ct, *rest):
    """Gradients of fn(*diff, *rest) for the numpy inputs `diff` under
    cotangent `ct`, through the port's wrapper."""
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in diff]
    out = fn(*xs, *rest)
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
    out.backward(_noncontig(ct))
    return [x.grad.numpy() for x in xs], out.detach().numpy()


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(scale, 1e-6), f"{what}: {err:.3g} > {TOL} x {scale:.3g}"


@pytest.mark.parametrize("with_bias,with_valid", [(False, False), (True, True)])
def test_sparse_conv_vjp_matches_jax(with_bias, with_valid):
    rng = np.random.RandomState(0)
    b, v_in, v_out, k, ci, co = 2, 40, 33, 27, 6, 5
    feats = rng.randn(b, v_in, ci).astype(np.float32)
    w = (rng.randn(k, ci, co) / 4).astype(np.float32)
    kmap = rng.randint(-1, v_in, size=(b, k, v_out)).astype(np.int32)
    bias = rng.randn(co).astype(np.float32) if with_bias else None
    valid = rng.rand(b, v_out) > 0.3 if with_valid else None
    ct = rng.randn(b, v_out, co).astype(np.float32)

    diff = [feats, w] + ([bias] if with_bias else [])

    def port(f, wt, *bb):
        return sparse_conv(f, wt, torch.from_numpy(kmap), bias=bb[0] if bb else None,
                           out_valid=None if valid is None else torch.from_numpy(valid))

    got, _ = _vjp_port(port, diff, ct)

    def jfn(f, wt, *bb):
        return sparse_conv_auto(f, wt, jnp.asarray(kmap), bias=bb[0] if bb else None,
                                out_valid=None if valid is None else jnp.asarray(valid))

    _, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in diff])
    for name, g, want in zip(("feats", "weights", "bias"), got, vjp(jnp.asarray(ct))):
        _close(g, np.asarray(want), name)


@pytest.mark.parametrize("tq,tk,d", [(64, 64, 16), (40, 77, 40)])
def test_attention_vjp_matches_jax(tq, tk, d):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 3, tq, d).astype(np.float32)
    k = rng.randn(2, 3, tk, d).astype(np.float32)
    v = rng.randn(2, 3, tk, d).astype(np.float32)
    ct = rng.randn(2, 3, tq, d).astype(np.float32)
    got, _ = _vjp_port(attention, [q, k, v], ct)
    _, vjp = jax.vjp(jax_attention, *[jnp.asarray(a) for a in (q, k, v)])
    for name, g, want in zip("qkv", got, vjp(jnp.asarray(ct))):
        _close(g, np.asarray(want), name)


def test_deform_attn_vjp_matches_jax():
    """Value, locations (some samples partly outside the maps) and weights."""
    rng = np.random.RandomState(2)
    shapes = ((6, 9), (3, 5))
    b, lq, heads, d, npts = 2, 21, 4, 8, 4
    value = rng.randn(b, sum(h * w for h, w in shapes), heads, d).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(b, lq, heads, len(shapes), npts, 2)).astype(np.float32)
    aw = rng.rand(b, lq, heads, len(shapes), npts).astype(np.float32)
    ct = rng.randn(b, lq, heads * d).astype(np.float32)
    got, _ = _vjp_port(lambda v, l, a: ms_deform_attn(v, shapes, l, a), [value, loc, aw], ct)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_auto(v, shapes, l, a),
                     *[jnp.asarray(a) for a in (value, loc, aw)])
    for name, g, want in zip(("value", "locations", "weights"), got, vjp(jnp.asarray(ct))):
        _close(g, np.asarray(want), name)


@pytest.mark.parametrize("prepared", [False, True])
def test_gn_silu_conv_vjp_matches_jax(prepared):
    """x, the norm's scale and bias, the raw conv weight and bias; with the
    kernel's prepared `params` passed too, which take no gradient."""
    rng = np.random.RandomState(3)
    c, cout = 16, 8
    x = rng.randn(2, 6, 7, c).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    w = (rng.randn(3, 3, c, cout) / 8).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    ct = rng.randn(2, 6, 7, cout).astype(np.float32)
    params = kernel_params(torch.from_numpy(w), torch.from_numpy(b), torch.float32) \
        if prepared else None
    got, _ = _vjp_port(lambda *a: gn_silu_conv(*a, groups=4, params=params),
                       [x, scale, bias, w, b], ct)
    _, vjp = jax.vjp(lambda *a: jax_gn_silu_conv(*a, groups=4),
                     *[jnp.asarray(a) for a in (x, scale, bias, w, b)])
    for name, g, want in zip(("x", "scale", "bias", "w", "b"), got, vjp(jnp.asarray(ct))):
        _close(g, np.asarray(want), name)


def test_backward_records_and_counts_no_launch():
    """The backward's recompute is plain PyTorch: the recorder hook sees the
    forward's call only."""
    seen = []
    _build.RECORDER = lambda name, args: seen.append(name)
    try:
        q = torch.randn(1, 2, 8, 16, requires_grad=True)
        attention(q, q.detach().clone(), q.detach().clone()).sum().backward()
    finally:
        _build.RECORDER = None
    assert seen == ["flash_attention"] and q.grad is not None


def test_masked_batchnorm_train_matches_jax():
    """Batch moments over valid voxels (biased variance to normalise), the
    running statistics moved with momentum 0.9 and the unbiased variance,
    and the gradients of x, scale and bias; fp32 running statistics."""
    rng = np.random.RandomState(4)
    x = (3 + 2 * rng.randn(2, 30, 8)).astype(np.float32)
    valid = rng.rand(2, 30) > 0.4
    ct = rng.randn(2, 30, 8).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    bias = (0.1 * rng.randn(8)).astype(np.float32)
    mean0 = (0.1 * rng.randn(8)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)

    jmod = JaxMaskedBatchNorm()
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def jfn(xx, s, bb):
        v = {"params": {"scale": s, "bias": bb}, "batch_stats": variables["batch_stats"]}
        return jmod.apply(v, xx, jnp.asarray(valid), True, mutable=["batch_stats"])

    (want, stats), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want_grads = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like, stats)))

    bn = MaskedBatchNorm(8).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out = bn(tx, torch.from_numpy(valid))
    out.backward(torch.from_numpy(ct))
    _close(out.detach().numpy(), np.asarray(want), "y")
    for name, g, w in zip(("x", "scale", "bias"), (tx.grad, bn.scale.grad, bn.bias.grad),
                          want_grads):
        _close(g.numpy(), np.asarray(w), name)
    for name in ("mean", "var"):
        assert getattr(bn, name).dtype == torch.float32
        np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(stats["batch_stats"][name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    # eval mode normalises with the running statistics and moves nothing
    bn.eval()
    before = bn.var.clone()
    y = bn(tx.detach(), torch.from_numpy(valid))
    assert torch.equal(bn.var, before)
    want_eval = jmod.apply({"params": {"scale": scale, "bias": bias},
                            "batch_stats": {k: np.asarray(v) for k, v in
                                            stats["batch_stats"].items()}},
                           jnp.asarray(x), jnp.asarray(valid), False)
    _close(y.detach().numpy(), np.asarray(want_eval), "eval y")


def test_masked_batchnorm_with_no_valid_voxel():
    """An all-padded batch: count clamped to 1, finite outputs and stats."""
    bn = MaskedBatchNorm(4).train()
    y = bn(torch.randn(1, 5, 4), torch.zeros(1, 5, dtype=torch.bool))
    assert torch.isfinite(y).all() and torch.isfinite(bn.var).all()
