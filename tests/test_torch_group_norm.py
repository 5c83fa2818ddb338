"""The models' GroupNorm and its wrapper (`ops/gn_conv.py` `group_norm`) on
the CPU: the SiLU flag, the plain formula the wrapper runs on CPU tensors,
and the routing of calls that autograd records. The kernel itself is held
to the same formula on the card (`tests/test_torch_kernels_gpu.py`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xmask3d_tpu_torch.models import layers
from xmask3d_tpu_torch.models.vae import ResnetBlock
from xmask3d_tpu_torch.ops import _build
from xmask3d_tpu_torch.ops import gn_conv as tgc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_formula(x, weight, bias, groups, eps=1e-6):
    """GroupNorm as the module computed it before it had a wrapper: one-pass
    fp32 statistics, var = max(0, E[x^2] - E[x]^2), the centred form."""
    cg = x.shape[-1] // groups
    xf = x.float().reshape(x.shape[0], -1, groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True).sub_(mean.square()).clamp_(min=0.0)
    mul = torch.rsqrt(var.add_(eps)) * weight.reshape(groups, cg)
    return torch.addcmul(bias.reshape(groups, cg), xf - mean, mul).reshape(x.shape).to(x.dtype)


def _norm(c, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    gn = layers.GroupNorm(c)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy((1.0 + 0.1 * rng.randn(c)).astype(np.float32)))
        gn.bias.copy_(torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)))
    return gn.to(dtype)


# (shape, values a group): odd widths (7 and 36 channels: groups of 1 and 2
# channels), a group of one value near 30, the model's usual 32 groups
SHAPES = [((2, 5, 3, 7), 15), ((1, 4, 9, 36), 72), ((2, 1, 1, 32), 1), ((1, 6, 10, 128), 240),
          ((2, 17, 320), 170)]


def _x(shape, values, seed, dtype):
    rng = np.random.RandomState(seed)
    if values <= 2:
        x = 30.0 + 0.05 * rng.randn(*shape)
    else:
        x = 3.0 * rng.randn(*shape) + 1.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,values", SHAPES)
def test_silu_flag_is_silu_after_the_norm(shape, values, dtype):
    """`GroupNorm(x, silu=True)` equals `F.silu(GroupNorm(x))` bit for bit on
    CPU tensors, in fp32 and in bf16 (SiLU of the rounded norm)."""
    gn = _norm(shape[-1], values, dtype)
    x = _x(shape, values, 3, dtype)
    assert gn.groups * values == np.prod(shape[1:])
    with torch.no_grad():
        got = gn(x, silu=True)
        want = F.silu(gn(x))
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,values", SHAPES)
def test_wrapper_on_cpu_is_the_module_formula(shape, values, dtype):
    """On CPU tensors the wrapper runs the plain formula: equal bit for bit to
    the formula the module has always computed, and to the module, at odd
    widths and at groups of one value; the recorder sees the call and no
    launch is counted."""
    gn = _norm(shape[-1], values + 1, dtype)
    x = _x(shape, values, 4, dtype)
    seen, n = [], tgc.group_norm.launches
    _build.RECORDER = lambda name, args: seen.append((name, args))
    try:
        got = tgc.group_norm(x, gn.weight.detach(), gn.bias.detach(), gn.groups, layers.EPS)
    finally:
        _build.RECORDER = None
    want = flax_formula(x, gn.weight.detach(), gn.bias.detach(), gn.groups)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(gn(x), want)
    assert tgc.group_norm.launches == n
    assert [s[0] for s in seen] == ["group_norm"] and seen[0][1][3:] == (gn.groups, 1e-6, False)
    assert torch.equal(tgc.group_norm_reference(x, gn.weight, gn.bias, gn.groups, silu=True),
                       F.silu(want))


@pytest.mark.parametrize("needs", ["x", "params", "both"])
def test_a_call_under_autograd_takes_the_plain_path(needs):
    """A call that autograd records computes the plain formula under
    autograd: output and gradients of x, weight and bias equal the formula's
    bit for bit, with SiLU on; `no_grad` and frozen inputs are not
    recorded."""
    gn = _norm(64, 7)
    x0 = _x((2, 6, 5, 64), 60, 8, torch.float32)
    ct = torch.from_numpy(np.random.RandomState(9).randn(2, 6, 5, 64).astype(np.float32))
    grads = []
    for fn in (lambda x: gn(x, silu=True),
               lambda x: F.silu(flax_formula(x, gn.weight, gn.bias, gn.groups))):
        x = x0.clone().requires_grad_(needs != "params")
        for p in gn.parameters():
            p.requires_grad_(needs != "x")
            p.grad = None
        y = fn(x)
        assert y.grad_fn is not None
        y.backward(ct)
        grads.append((y.detach(), x.grad, gn.weight.grad, gn.bias.grad))
    for got, want in zip(*grads):
        assert (got is None and want is None) or torch.equal(got, want)
    assert tgc.records_grad(x0.requires_grad_(), gn.weight)
    with torch.no_grad():
        assert not tgc.records_grad(x0, gn.weight)
    gn.requires_grad_(False)
    assert not tgc.records_grad(x0.detach(), gn.weight, gn.bias)


def test_unfused_resnet_block_stage_fuses_silu_into_the_norm():
    """The VAE resblock without `fused_gn` is conv(SiLU(norm(x))) as before,
    bit for bit, now through the norm's flag."""
    torch.manual_seed(0)
    blk = ResnetBlock(64, 96)
    x = torch.randn(1, 6, 7, 64)
    with torch.no_grad():
        h = blk.conv1(F.silu(flax_formula(x, blk.norm1.weight, blk.norm1.bias, blk.norm1.groups)))
        h = blk.conv2(F.silu(flax_formula(h, blk.norm2.weight, blk.norm2.bias, blk.norm2.groups)))
        want = blk.nin_shortcut(x) + h
        assert torch.equal(blk(x), want)


def test_wrapper_refuses_bad_shapes():
    x, w = torch.ones(1, 2, 2, 12), torch.ones(12)
    with pytest.raises(ValueError, match="groups"):
        tgc.group_norm(x, w, w, 5)
    with pytest.raises(ValueError, match="weight"):
        tgc.group_norm(x, w[:8], w, 4)
    with pytest.raises(ValueError, match="groups"):
        tgc.group_norm(torch.ones(12), w, w, 4)
