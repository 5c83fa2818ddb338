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

EPS = 1e-6


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
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` over NHWC tensors (eps 1e-6)."""

    def __init__(self, channels: int, preferred: int = 32):
        super().__init__()
        self.groups = gn_groups(channels, preferred)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), self.groups, self.weight, self.bias, EPS)
        return y.permute(0, 2, 3, 1)


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


def _weight_mat(n_in: int, n_out: int, kernel, antialias: bool, device) -> torch.Tensor:
    """(n_in, n_out) resampling matrix with `jax.image.resize` semantics:
    half-pixel centres, weights renormalised to sum 1, zero where the sample
    lies entirely outside the input."""
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
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


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
        w = _weight_mat(n_in, n_out, kernel, antialias, y.device)
        y = torch.movedim(torch.movedim(y, d, -1) @ w, -1, d)
    return y.to(dtype)
