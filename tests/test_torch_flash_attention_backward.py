"""K2's backward on the CPU: the plain statement of the kernels' contract,
which call takes which backward, and the counter.

A bf16 CUDA call of head dim up to 160 that autograd records saves the
rows' log-sum-exp and takes the kernels' FlashAttention-2 backward
(`attn_bwd_*`, on the card in `tests/test_torch_kernels_gpu.py`); here its
plain statement, `attention_backward_reference`, must equal
autograd through `reference_attention` in fp32 up to summation order. Every
CPU call takes the plain VJP.
"""

import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.ops import flash_attention as tfa

# fp32 against fp32 in another order: dq sums dS K over rows of dS that sum
# to zero, which leaves ~3e-5 of the largest gradient under some thread
# counts; the card's fp32 tolerance
TOL = 1e-4


def _qkv(seed, b, h, tq, tk, d, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dtype)
            for t in (tq, tk, tk, tq)]


def _close(got, want, what):
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), (what, err)


# the model's head dims (SD UNet 40 / 80 / 160), 77 text keys, the 64-token
# mid block, a ragged 300-key edge, and queries that differ from the keys
@pytest.mark.parametrize("tq,tk,d", [(64, 77, 40), (64, 64, 80), (100, 300, 160),
                                     (130, 77, 80), (77, 300, 40), (256, 64, 160)])
def test_backward_statement_matches_autograd(tq, tk, d):
    q, k, v, do = _qkv(tq + tk + d, 2, 3, tq, tk, d)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reference_attention(*xs).backward(do)
    _, lse = tfa.reference_attention_lse(q, k, v)
    got = tfa.attention_backward_reference(q, k, v, lse, do)
    for name, g, x in zip("qkv", got, xs):
        assert g.dtype == torch.float32 and g.shape == x.shape
        _close(g, x.grad, name)


@pytest.mark.parametrize("tq,tk,d", [(64, 77, 40), (100, 300, 160)])
def test_forward_statement_output_and_lse(tq, tk, d):
    """The output as `reference_attention`'s, the log-sum-exp as
    torch.logsumexp of the scaled fp32 scores."""
    q, k, v, _ = _qkv(d, 2, 2, tq, tk, d)
    q[0, 0, :3] *= 40.0  # near one-hot rows: the max carries the sum
    o, lse = tfa.reference_attention_lse(q, k, v)
    assert lse.shape == (2, 2, tq) and lse.dtype == torch.float32
    _close(o, tfa.reference_attention(q, k, v), "o")
    want = torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", q, k) / d ** 0.5, dim=-1)
    _close(lse, want, "lse")
    o16, lse16 = tfa.reference_attention_lse(*(t.bfloat16() for t in (q, k, v)))
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32


def test_backward_statement_in_bf16_inputs_reads_them_in_fp32():
    """The kernels read bf16 inputs; the statement takes them as they are
    and computes in fp32, as the plain VJP of the same bf16 values does."""
    q, k, v, do = _qkv(5, 1, 2, 96, 77, 40, torch.bfloat16)
    xs = [t.float().clone().requires_grad_() for t in (q, k, v)]
    tfa.reference_attention(*xs).backward(do.float())
    _, lse = tfa.reference_attention_lse(*(t.float() for t in (q, k, v)))
    got = tfa.attention_backward_reference(q, k, v, lse, do)
    for name, g, x in zip("qkv", got, xs):
        _close(g, x.grad, name)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 20, 48), (torch.bfloat16, 40, 48), (torch.bfloat16, 48, 48),
    (torch.bfloat16, 49, 80), (torch.bfloat16, 80, 80), (torch.bfloat16, 96, 160),
    (torch.bfloat16, 160, 160), (torch.bfloat16, 161, 0), (torch.bfloat16, 512, 0),
    (torch.float32, 40, 0), (torch.float32, 160, 0)])
def test_backward_route_of_each_dtype_and_head_dim(dtype, d, want):
    """bf16 up to d 160 takes the kernels at the smallest backward width that
    holds d; fp32 and wider heads the plain VJP. Keys and queries do not
    matter."""
    assert tfa.backward_plan(dtype, d) == want
    if want:
        assert want in tfa.BACKWARD_WIDTHS and want >= d


def test_model_head_dims_take_the_kernels():
    """Every SD UNet attention's head dim (40, 80, 160) has a backward width;
    the VAE's single 512-wide head, whose calls take no gradient, has none."""
    from xmask3d_tpu_torch.models.ldm_extractor import LDM_SD_V1 as c

    u = c.unet
    dims = {u.model_channels * m // u.num_heads for m in u.ch_mult}
    assert dims == {40, 80, 160}
    assert all(tfa.backward_plan(torch.bfloat16, d) for d in dims)
    assert tfa.backward_plan(torch.bfloat16, c.vae.ch * c.vae.ch_mult[-1]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_take_the_plain_vjp(dtype):
    """A CPU call, bf16 included, counts its backward as plain and leaves
    the kernel count where it was; its gradients are the plain VJP's."""
    q, k, v, do = _qkv(3, 1, 2, 40, 77, 40, dtype)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(tfa.attention.backward_calls)
    tfa.attention(*xs).backward(do)
    assert tfa.attention.backward_calls == {"kernel": before["kernel"],
                                            "plain": before["plain"] + 1}
    tfa.reference_attention(*ys).backward(do)
    for x, y in zip(xs, ys):
        assert torch.equal(x.grad, y.grad)


def test_unrecorded_calls_count_no_backward():
    """No gradient wanted (no_grad, or no input requiring one): nothing is
    saved for a backward and neither count moves."""
    q, k, v, _ = _qkv(4, 1, 1, 16, 16, 40)
    before = dict(tfa.attention.backward_calls)
    with torch.no_grad():
        a = tfa.attention(q.requires_grad_(), k, v)
    b = tfa.attention(q.detach(), k, v)
    assert a.grad_fn is None and b.grad_fn is None
    assert tfa.attention.backward_calls == before
