"""Small shared layers: NHWC convs and norms with flax's conventions, and
JAX-exact image resizes.

Norms use eps=1e-6 (flax's default; torch's is 1e-5). NHWC tensors go to
cuDNN through a channels-last NCHW view, so no layout copy is made.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.device import device_constant

EPS = 1e-6


class RematBlock(nn.Module):
    """A block whose activations, with `remat` set, are not kept for the
    backward but recomputed there from its inputs
    (`torch.utils.checkpoint`, non-reentrant). Only a call that autograd
    records is checkpointed. Subclasses define `body`."""

    remat = False

    def forward(self, *args):
        if self.remat and torch.is_grad_enabled() and (
                any(torch.is_tensor(a) and a.requires_grad for a in args)
                or any(p.requires_grad for p in self.parameters())):
            return checkpoint(self.body, *args, use_reentrant=False)
        return self.body(*args)


def set_remat(module: nn.Module, on: bool) -> int:
    """Sets `remat` on every RematBlock inside `module`; returns their
    count."""
    blocks = [m for m in module.modules() if isinstance(m, RematBlock)]
    for m in blocks:
        m.remat = on
    return len(blocks)


def gn_groups(channels: int, preferred: int = 32) -> int:
    """Largest group count <= preferred that divides `channels`."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


class Conv(nn.Module):
    """2D conv over NHWC tensors (flax `nn.Conv` with symmetric integer
    padding); weight stored OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` over channels-last tensors (eps 1e-6), computed
    as flax computes it: fp32 statistics per (batch, group) in one pass,
    var = max(0, E[x^2] - E[x]^2), then (x - mean) * (rsqrt(var + eps) *
    scale) + bias, cast back to the input's type. Any group size is taken,
    one value included.

    The per-channel fold x * a + (bias - mean * a) would save a pass but
    cancels where |mean| * rsqrt(var + eps) is large (groups of one value
    near 30 miss flax by 1.7e-3 in fp32), so the centred form stays. The
    parameters are promoted to fp32 inside the ops that read them."""

    def __init__(self, channels: int, preferred: int = 32):
        super().__init__()
        self.groups = gn_groups(channels, preferred)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        cg = x.shape[-1] // g
        xf = x.float().reshape(x.shape[0], -1, g, cg)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.square().mean(dim=(1, 3), keepdim=True).sub_(mean.square()).clamp_(min=0.0)
        mul = torch.rsqrt(var.add_(EPS)) * self.weight.reshape(g, cg)
        y = torch.addcmul(self.bias.reshape(g, cg), xf - mean, mul)
        return y.reshape(x.shape).to(x.dtype)


def LayerNorm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=EPS)


def upsample_nearest_int(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Integer-factor nearest upsample of (B, H, W, C) (plain repetition)."""
    return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return upsample_nearest_int(x, 2, 2)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5 (x >= 0)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(n_in: int, n_out: int, kernel, antialias: bool) -> torch.Tensor:
    """(n_in, n_out) resampling matrix with `jax.image.resize` semantics:
    half-pixel centres, weights renormalised to sum 1, zero where the sample
    lies entirely outside the input. Built on the host."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    inv = 1.0 / scale
    kscale = torch.clamp(inv, min=1.0) if antialias else torch.tensor(1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kscale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: Tuple[int, int], dims: Sequence[int],
           method: str = "bilinear", antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize` with `method` in {"bilinear", "bicubic"} over the
    two spatial `dims` of x (computed in fp32, cast back)."""
    kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}[method]
    dtype = x.dtype
    y = x.float()
    for d, n_out in zip(dims, size):
        n_in = y.shape[d]
        if n_in == n_out:
            continue
        w = device_constant(("resize", n_in, n_out, method, antialias), y.device,
                            lambda: _weight_mat(n_in, n_out, kernel, antialias))
        y = torch.movedim(torch.movedim(y, d, -1) @ w, -1, d)
    return y.to(dtype)
