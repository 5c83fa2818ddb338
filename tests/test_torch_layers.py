"""The port's LayerNorm against flax's, where their formulas could part.

flax's `nn.LayerNorm` takes the one-pass variance max(0, E[x^2] - E[x]^2) in
fp32; the port's is `torch.nn.LayerNorm` (eps 1e-6), which centres first.
The two can only part where E[x^2] - E[x]^2 cancels: rows with a large mean
and a small spread. The cases are such rows at the widths the towers use
(768 CLIP text and SD context, 1024 CLIP vision, 1280 the SD UNet's deepest
transformer), in fp32.

Where the one-pass variance is well conditioned (|mean| up to 3 spreads) the
two must agree within 1e-5 of the output's largest value. Beyond that the
one-pass variance is rounding noise of its own sums (at mean 30 and spread
0.5, one ulp of E[x^2] is 2.4e-4 of the variance), which no other
implementation can reproduce: adopting flax's formula in PyTorch parts from
flax as far as `torch.nn.LayerNorm` does, because the two frameworks add in
different orders (tried: 9e-4 at mean 30, where `torch.nn.LayerNorm` parts
by 6e-4). There the test holds both to the float64 result instead: the port
must be within 1e-4 of it (fp32 itself resolves a spread of 0.05 around 50
to 1e-4) and never further from it than flax.
"""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.models.layers import EPS, LayerNorm

# (mean, spread, well conditioned)
ROWS = [(0.0, 1.0, True), (3.0, 1.0, True), (-2.0, 0.7, True), (30.0, 0.5, False),
        (100.0, 1.0, False), (50.0, 0.05, False)]


def _both(width, mean, spread):
    rng = np.random.RandomState(width + int(abs(mean)))
    x = (mean + spread * rng.randn(2, 7, width)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(width)).astype(np.float32)
    bias = (0.1 * rng.randn(width)).astype(np.float32)
    mod = nn.LayerNorm(epsilon=EPS)
    flax_out = np.asarray(mod.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x)))
    ln = LayerNorm(width)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        port_out = ln(torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    mu = x64.mean(-1, keepdims=True)
    exact = (x64 - mu) / np.sqrt(x64.var(-1, keepdims=True) + EPS) * scale + bias
    return port_out, flax_out, exact


@pytest.mark.parametrize("width", [768, 1024, 1280])
@pytest.mark.parametrize("mean,spread,well", ROWS)
def test_layernorm_matches_flax(width, mean, spread, well):
    port, flax_out, exact = _both(width, mean, spread)
    top = max(1.0, np.abs(exact).max())
    to_flax = np.abs(port - flax_out).max() / top
    port_err = np.abs(port - exact).max() / top
    flax_err = np.abs(flax_out - exact).max() / top
    print(f"width {width} mean {mean} spread {spread}: port-flax {to_flax:.3e} "
          f"port-exact {port_err:.3e} flax-exact {flax_err:.3e}")
    if well:
        assert to_flax <= 1e-5 and port_err <= 1e-5, (to_flax, port_err)
    else:
        assert port_err <= 1e-4 and port_err <= flax_err, (port_err, flax_err)
