"""The port's W8A8 op (`xmask3d_tpu_torch/ops/int8_quant.py`) against the
JAX package's (`xmask3d_tpu/ops/int8_quant.py`), fp32 on the CPU.

- `quant_dot` and `quant_conv`: the int8 operands and the int32 products
  bit-equal to the JAX op's (its own `_quant_weight` and the expressions of
  its function body), the outputs within 1 ulp of the JAX function's.
- `QDense` / `QConv` with the same parameters (the weight bridge's
  layouts): within 1 ulp of JAX's with int8 on; with it off, the plain
  matmul / conv within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmask3d_tpu.ops.int8_quant as jq
from xmask3d_tpu_torch.ops import int8_quant as q

OFF_TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    jq.set_int8(None)
    q.set_int8(None)


def _jax_act(x, axis):
    xf = jnp.asarray(x, jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=axis, keepdims=axis is not None) / 127.0, 1e-8)
    return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)


def test_quant_dot_equals_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 96).astype(np.float32)
    w = (rng.randn(96, 136) * 0.05).astype(np.float32)
    xq, wq, y, _, _ = q.quant_dot_int(torch.from_numpy(x), torch.from_numpy(w))
    jxq = _jax_act(x, -1)
    jwq, _ = jq._quant_weight(jnp.asarray(w))
    jy = jax.lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    got = q.quant_dot(torch.from_numpy(x), torch.from_numpy(w), torch.float32)
    want = jq.quant_dot(jnp.asarray(x), jnp.asarray(w), jnp.float32)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


@pytest.mark.parametrize("stride,padding", [((1, 1), "SAME"), ((2, 2), "SAME"),
                                            ((2, 2), "VALID"), ((1, 1), [(1, 1), (1, 1)])])
def test_quant_conv_equals_jax(stride, padding):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 10, 9, 64).astype(np.float32)
    w = (rng.randn(3, 3, 64, 72) * 0.05).astype(np.float32)  # HWIO
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    xq, wq, y, _, _ = q.quant_conv_int(torch.from_numpy(x), w_oihw, stride, padding)
    jxq = _jax_act(x, None)
    jwq, _ = jq._quant_weight(jnp.asarray(w))
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    jy = jax.lax.conv_general_dilated(jxq, jwq, stride, padding, dimension_numbers=dn,
                                      preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    got = q.quant_conv(torch.from_numpy(x), w_oihw, stride, padding, torch.float32)
    want = jq.quant_conv(jnp.asarray(x), jnp.asarray(w), stride, padding, jnp.float32)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


@pytest.mark.parametrize("on", [True, False])
def test_qdense_and_qconv_equal_jax(on):
    rng = np.random.RandomState(2)
    key = jax.random.PRNGKey(3)
    x = rng.randn(3, 7, 96).astype(np.float32)
    jd = jq.QDense(128, dtype=jnp.float32)
    vd = jd.init(key, jnp.asarray(x))
    pd = q.QDense(96, 128)
    with torch.no_grad():
        pd.weight.copy_(torch.from_numpy(np.asarray(vd["params"]["kernel"]).T.copy()))
        pd.bias.copy_(torch.from_numpy(np.array(vd["params"]["bias"])))
    img = rng.randn(1, 10, 10, 64).astype(np.float32)
    jc = jq.QConv(96, kernel_size=(3, 3), strides=(2, 2), padding="SAME", dtype=jnp.float32)
    vc = jc.init(key, jnp.asarray(img))
    pc = q.QConv(64, 96, 3, stride=2, padding="SAME")
    with torch.no_grad():
        pc.weight.copy_(torch.from_numpy(
            np.asarray(vc["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        pc.bias.copy_(torch.from_numpy(np.asarray(vc["params"]["bias"]) + 0.5))
    vc = {"params": {**vc["params"], "bias": vc["params"]["bias"] + 0.5}}
    jq.set_int8(on)
    q.set_int8(on)
    pairs = ((pd(torch.from_numpy(x)), jd.apply(vd, jnp.asarray(x))),
             (pc(torch.from_numpy(img)), jc.apply(vc, jnp.asarray(img))))
    for got, want in pairs:
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        if on:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_allclose(got, want, rtol=OFF_TOL, atol=OFF_TOL)


def test_the_switch_follows_the_environment(monkeypatch):
    monkeypatch.setenv("XMASK3D_INT8", "1")
    assert q.int8_enabled()
    monkeypatch.setenv("XMASK3D_INT8", "0")
    assert not q.int8_enabled()
    q.set_int8(True)
    assert q.int8_enabled()
