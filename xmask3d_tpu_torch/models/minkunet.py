"""MinkowskiNet-style sparse UNet over a `SparseHierarchy`.

Counterpart of `xmask3d_tpu/models/minkunet.py` (eval path). Tensors are
batch-padded (B, V_l, C) with validity masks from the hierarchy. Returns
(bottleneck stride-16 features, stride-1 output features).

With `XMASK3D_BRICK=1` and a hierarchy built with brick metadata, each
stage of residual blocks and the k5 stem run in the brick-dense layout
(`ops/brick_conv.py`): one scatter in and one gather out a stage, every
k3 / k5 conv inside a dense conv over halo'd bricks. Otherwise, and for
the strided and transposed convs always, the convs take their kernel maps
(K1).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xmask3d_tpu_torch.ops.brick_conv import brick_conv, from_brick, level_brick, to_brick
from xmask3d_tpu_torch.ops.sparse_conv import (
    SAME_LEVEL,
    SparseHierarchy,
    down_transposes,
    sparse_conv,
    sparse_conv_transpose,
)
from xmask3d_tpu_torch.parallel.mesh import all_reduce_with_grad


def bricks_enabled() -> bool:
    """XMASK3D_BRICK=1 runs the 3D UNets' k3 / k5 convs brick-dense where
    the hierarchy carries brick metadata (off by default, as in the JAX
    package; the fused stem is off under it)."""
    return os.environ.get("XMASK3D_BRICK", "0") == "1"


def _zero_invalid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid voxels of a (B, V, C) tensor. In training
    mode it normalises with the batch's fp32 moments over valid voxels
    (biased variance) and moves the fp32 running statistics by
    `running = momentum * running + (1 - momentum) * batch`, with the
    unbiased variance, as the JAX package does; in eval mode it normalises
    with the running statistics. Params `scale`/`bias` and buffers
    `mean`/`var` keep flax's names. Under a process group the count and the
    moments' sums are added over the data axis's ranks before dividing,
    where the JAX package `psum`s them, by a reduction whose backward adds
    the ranks' gradients: the statistics, their gradient and the running
    statistics are those of the global batch on every rank (a model
    group's ranks hold the same rows: the sum is not taken over them)."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.training:
            c = x.shape[-1]
            m = valid[..., None].float()
            xf = x.float()
            sums = all_reduce_with_grad(torch.cat([
                m.sum().reshape(1), (xf * m).sum(dim=(0, 1)), (xf * xf * m).sum(dim=(0, 1))]))
            cnt = sums[0].clamp(min=1.0)
            mean = sums[1:1 + c] / cnt
            var = (sums[1 + c:] / cnt - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * (cnt / (cnt - 1.0).clamp(min=1.0))
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * unbiased)
        else:
            mean, var = self.mean.float(), self.var.float()
        inv = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (x.float() - mean) * inv + self.bias.float()
        return y.to(x.dtype)


class SparseConv(nn.Module):
    """Sparse conv over a precomputed kernel map; kernel (K, C_in, C_out)."""

    def __init__(self, in_ch: int, out_ch: int, num_offsets: int, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_offsets, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        nn.init.normal_(self.kernel, std=(2.0 / (num_offsets * out_ch)) ** 0.5)

    def forward(self, x, kmap: Optional[torch.Tensor], out_valid=None, brick=None,
                transpose=None):
        """`brick`: the level's brick metadata when x is in the brick-dense
        layout (then `out_valid` is its slot validity); a k3 / k5 conv then
        runs as `brick_conv`. `transpose`: the map's transpose for K1's
        backward (`sparse_conv`)."""
        w = self.kernel.to(x.dtype)
        if kmap is None:  # 1x1 conv == plain matmul on the same coord map
            out = x @ w[0]
            if self.bias is not None:
                out = out + self.bias.to(out.dtype)
            return out if out_valid is None else _zero_invalid(out, out_valid)
        if brick is not None and w.shape[0] in (27, 125):
            return brick_conv(x, w, brick[0], slot_valid=out_valid, bias=self.bias)
        return sparse_conv(x, w, kmap, bias=self.bias, out_valid=out_valid, transpose=transpose)


class SparseConvTranspose(nn.Module):
    """Generative transposed conv (kernel 2, stride 2): parent gather."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, in_ch, out_ch))
        nn.init.normal_(self.kernel, std=(2.0 / (8 * out_ch)) ** 0.5)

    def forward(self, x, parent, octant):
        return sparse_conv_transpose(x, self.kernel.to(x.dtype), parent, octant)


class BasicBlock(nn.Module):
    """Residual block of two kernel-3 sparse convs."""

    def __init__(self, in_ch: int, planes: int):
        super().__init__()
        self.conv1 = SparseConv(in_ch, planes, 27)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27)
        self.norm2 = MaskedBatchNorm(planes)
        if in_ch != planes:
            self.downsample_conv = SparseConv(in_ch, planes, 1)
            self.downsample_norm = MaskedBatchNorm(planes)

    def forward(self, x, kmap3, valid, brick=None):
        out = F.relu(self.norm1(self.conv1(x, kmap3, out_valid=valid, brick=brick,
                                           transpose=SAME_LEVEL), valid))
        out = self.norm2(self.conv2(out, kmap3, out_valid=valid, brick=brick,
                                    transpose=SAME_LEVEL), valid)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, None), valid)
        return _zero_invalid(F.relu(out + residual), valid)


_VARIANTS = {
    "MinkUNet14A": ((32, 64, 128, 256, 128, 128, 96, 96), (1,) * 8),
    "MinkUNet14B": ((32, 64, 128, 256, 128, 128, 128, 128), (1,) * 8),
    "MinkUNet14C": ((32, 64, 128, 256, 192, 192, 128, 128), (1,) * 8),
    "MinkUNet14D": ((32, 64, 128, 256, 384, 384, 384, 384), (1,) * 8),
    "MinkUNet18A": ((32, 64, 128, 256, 128, 128, 96, 96), (2,) * 8),
    "MinkUNet18B": ((32, 64, 128, 256, 128, 128, 128, 128), (2,) * 8),
    "MinkUNet18D": ((32, 64, 128, 256, 384, 384, 384, 384), (2,) * 8),
    "MinkUNet34A": ((32, 64, 128, 256, 256, 128, 64, 64), (2, 3, 4, 6, 2, 2, 2, 2)),
    "MinkUNet34B": ((32, 64, 128, 256, 256, 128, 64, 32), (2, 3, 4, 6, 2, 2, 2, 2)),
    "MinkUNet34C": ((32, 64, 128, 256, 256, 128, 96, 96), (2, 3, 4, 6, 2, 2, 2, 2)),
}


class MinkUNet(nn.Module):
    """Choy-style MinkUNet: k5 stem, 4 strided encoder stages, 4
    transposed-conv decoder stages with skip concatenation, 1x1 head."""

    def __init__(self, in_channels: int, out_channels: int, planes: Sequence[int],
                 layers: Sequence[int], init_dim: int = 32, stem_kernel: int = 125):
        super().__init__()
        self.planes, self.layers = tuple(planes), tuple(layers)
        self.conv0 = SparseConv(in_channels, init_dim, stem_kernel)
        self.bn0 = MaskedBatchNorm(init_dim)
        ch = init_dim
        skip_ch = [init_dim]
        for s in range(4):
            setattr(self, f"conv{s + 1}", SparseConv(ch, ch, 8))
            setattr(self, f"bn{s + 1}", MaskedBatchNorm(ch))
            for i in range(layers[s]):
                setattr(self, f"block{s + 1}_{i}", BasicBlock(ch if i == 0 else planes[s], planes[s]))
            ch = planes[s]
            if s < 3:
                skip_ch.append(ch)
        for d in range(4):
            p = planes[4 + d]
            setattr(self, f"convtr{4 + d}", SparseConvTranspose(ch, p))
            setattr(self, f"bntr{4 + d}", MaskedBatchNorm(p))
            cat = p + skip_ch[3 - d]
            for i in range(layers[4 + d]):
                setattr(self, f"block{5 + d}_{i}", BasicBlock(cat if i == 0 else p, p))
            ch = p
        self.final = SparseConv(ch, out_channels, 1)

    def _stage(self, x, n_blocks, level, name):
        """A run of residual blocks at one level; brick-dense (one scatter
        in, one gather out) when bricks are on and the level has them."""
        brick = level_brick(level) if bricks_enabled() else None
        valid = level.valid
        if brick is not None:
            x, valid = to_brick(x, brick[1], brick[2].shape[-1]), brick[2]
        for i in range(n_blocks):
            x = getattr(self, f"{name}_{i}")(x, level.kmap3, valid, brick=brick)
        if brick is not None:
            x = _zero_invalid(from_brick(x, brick[1]), level.valid)
        return x

    def forward(self, feats: torch.Tensor, h: SparseHierarchy,
                stem_conv: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        lv = h.levels
        brick0 = level_brick(lv[0]) if bricks_enabled() else None
        if stem_conv is None and brick0 is not None:
            # the k5 stem brick-dense (r = 2: 8^3 halo'd bricks)
            _, sor0, sv0 = brick0
            x = self.conv0(to_brick(feats, sor0, sv0.shape[-1]), h.kmap5, out_valid=sv0,
                           brick=brick0)
            x = _zero_invalid(from_brick(F.relu(self.bn0(x, sv0)), sor0), lv[0].valid)
        else:
            if stem_conv is None:
                stem_conv = self.conv0(feats, h.kmap5, out_valid=lv[0].valid, transpose=SAME_LEVEL)
            x = F.relu(self.bn0(stem_conv, lv[0].valid))
        skips = [x]
        # the down maps' transposes, for K1's backward (none without autograd)
        down_t = down_transposes(h) if torch.is_grad_enabled() else (None,) * len(h.down)
        for s in range(4):
            x = getattr(self, f"conv{s + 1}")(x, h.down[s], out_valid=lv[s + 1].valid,
                                              transpose=down_t[s])
            x = F.relu(getattr(self, f"bn{s + 1}")(x, lv[s + 1].valid))
            x = self._stage(x, self.layers[s], lv[s + 1], f"block{s + 1}")
            if s < 3:
                skips.append(x)
        bottleneck = x
        for d in range(4):
            tgt = 3 - d
            x = getattr(self, f"convtr{4 + d}")(x, h.up_parent[tgt], h.up_octant[tgt])
            x = F.relu(getattr(self, f"bntr{4 + d}")(x, lv[tgt].valid))
            x = torch.cat([x, skips[tgt]], dim=-1)
            x = self._stage(x, self.layers[4 + d], lv[tgt], f"block{5 + d}")
        out = self.final(x, None, out_valid=lv[0].valid)
        return bottleneck, out


def mink_unet(out_channels: int = 20, arch: str = "MinkUNet18A", in_channels: int = 3) -> MinkUNet:
    if arch not in _VARIANTS:
        raise ValueError(f"architecture {arch} not supported")
    planes, layers = _VARIANTS[arch]
    return MinkUNet(in_channels, out_channels, planes, layers)
