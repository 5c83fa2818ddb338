"""GroupNorm -> SiLU -> 3x3 SAME conv from the raw activation: kernel K4 and
its plain version.

Counterpart of `xmask3d_tpu/ops/gn_conv.py`, used by the VAE resblocks when
`fused_gn` is on. On a CUDA tensor a call is three launches: the group
statistics (`gn_stats_kernel`, per-block Welford moments of x read once in
its own type), their merge into the per-(batch, channel) affine
(`gn_affine_kernel`), and the conv, which applies the affine and SiLU while
it stages its input tile, so the normalised activation never reaches device
memory. Layout is the JAX contract: x (B, H, W, C), w HWIO (3, 3, C, C_out).
The kernels take any shape (the statistics up to 29,055 channels, a pixel
row's moments in shared memory), so there is no shape gate; on a CPU tensor
the plain versions run (`affine_from_stats`, `gn_silu_conv_reference`).
`gn_silu_conv` is differentiable in x, scale, bias, w and b: its backward is
the plain version's VJP.

On a row band of a map split over ranks (`parallel/spatial.py`) the three
steps are apart: `group_moments` (the statistics kernel's per-(batch, group)
count, mean and M2 of the band, merged over its blocks in fp64), the ranks'
moments merged in rank order by `affine_from_moments` (the affine kernel's
formula, in fp64, rounded once to fp32), and `affine_silu_conv` (the conv
kernel on the band with its neighbours' raw edge rows, given the affine).

`group_norm` is the models' plain GroupNorm (`models/layers.py`) on the
card: the same statistics kernels, merged into moments, then
`gn_apply_kernel`, which normalises x in the centred form with SiLU fused
where asked. Calls that autograd records, and CPU tensors, run its plain
version `group_norm_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from xmask3d_tpu_torch.ops import _build


def gn_silu_conv_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           w: torch.Tensor, b: torch.Tensor, groups: int = 32,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain version: two-pass fp32 group statistics, the affine and SiLU in
    fp32, rounded to x's type; then the 3x3 SAME conv of those values with
    fp32 sums, plus the bias in fp32, cast once to x's type."""
    bsz, h, wd, c = x.shape
    xf = x.float().reshape(bsz, h, wd, groups, c // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    n = ((xf - mean) * torch.rsqrt(var + eps)).reshape(bsz, h, wd, c)
    n = n * scale.float() + bias.float()
    n = (n * torch.sigmoid(n)).to(x.dtype)
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(n.float().permute(0, 3, 1, 2), wf, padding=1).permute(0, 2, 3, 1)
    return (out + b.float()).to(x.dtype)


def affine_from_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      groups: int, eps: float):
    """Per-(batch, channel) fp32 (a, s), each (B, C), with x * a + s equal to
    the GroupNorm affine: K4's statistics on CPU tensors. The statistics are
    stable ones in fp32 (Welford's in one pass of `var_mean`), equal to the
    plain version's two-pass ones up to rounding."""
    bsz, h, wd, c = x.shape
    cg = c // groups
    xf = x.float().reshape(bsz, h * wd, groups, cg)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0)  # (B, G)
    # (B, G, 1) against the (G, C/G) parameters, promoted to fp32 in the op
    a = torch.rsqrt(var.add_(eps)).unsqueeze(2) * scale.reshape(groups, cg)
    s = torch.addcmul(bias.reshape(groups, cg), mean.unsqueeze(2), a, value=-1.0)
    return a.reshape(bsz, c), s.reshape(bsz, c)


def moments_reference(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of `group_moments`: (B, G, 3) fp64 (count, mean, M2)
    of x (B, H, W, C) per (batch, group), in two fp64 passes."""
    bsz, h, wd, c = x.shape
    xf = x.double().reshape(bsz, h * wd, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    m2 = (xf - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([torch.full_like(mean, h * wd * (c // groups)), mean, m2], dim=-1)


def affine_from_moments(moments: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-6):
    """(a, s), each (B, C) fp32, of the GroupNorm over the union of the
    parts whose moments are given: (R, B, G, 3) (count, mean, M2, each
    part's `group_moments`, in rank order). The parts are merged in that
    order by Chan's formula in closed form in fp64 (the count-weighted mean,
    then M2 = sum of the parts' M2 + n_k (mean_k - mean)^2), then a = scale
    / sqrt(max(M2 / n, 0) + eps) and s = bias - mean a, each rounded once to
    fp32: `gn_affine_kernel`'s merge of its blocks. Differentiable in the
    means, the M2s, scale and bias (the counts are constants)."""
    counts = moments[..., 0].detach()
    n = counts.sum(0)
    mean = sum(counts[k] * moments[k, ..., 1] for k in range(moments.shape[0])) / n
    m2 = sum(moments[k, ..., 2] + counts[k] * (moments[k, ..., 1] - mean).square()
             for k in range(moments.shape[0]))
    inv = 1.0 / torch.sqrt((m2 / n).clamp(min=0.0) + eps)
    bsz, groups = mean.shape
    av = inv[..., None] * scale.double().reshape(groups, -1)
    s = bias.double().reshape(groups, -1) - mean[..., None] * av
    return av.float().reshape(bsz, -1), s.float().reshape(bsz, -1)


def affine_silu_conv_reference(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                               w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of `affine_silu_conv`: SiLU(x a + s) in fp32 rounded to
    x's type, zero outside x's rows and columns, then the 3x3 conv with fp32
    sums, plus the bias in fp32, cast once to x's type."""
    n = x.float() * a[:, None, None, :] + s[:, None, None, :]
    n = (n * torch.sigmoid(n)).to(x.dtype)
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(n.float().permute(0, 3, 1, 2), wf, padding=1).permute(0, 2, 3, 1)
    return (out + b.float()).to(x.dtype)


SM_COUNT = 132          # H100 SXM
TILE_ROWS, TILE_COLS = 4, 64   # the bf16 conv's output tile (256 pixels)
CHUNK = 64              # input channels a staged chunk of the bf16 conv
COUT_PAD = 128          # the bf16 weight layout pads C_out to this
STATS_THREADS = 256


def kernel_plan(dtype: torch.dtype, bsz: int, h: int, w: int, c_out: int) -> Tuple[str, int]:
    """(variant name, output channels a block) of the conv kernel a call
    takes. bf16 runs on the tensor cores (wgmma) with 256-pixel tiles and 128
    output channels a block; where that grid would leave SMs idle (the 64^2
    maps of 512 channels: 64 blocks) a block holds 64. fp32 runs on CUDA
    cores."""
    if dtype == torch.float32:
        return "fma_fp32", 0
    tiles = bsz * -(-h // TILE_ROWS) * -(-w // TILE_COLS)
    bn = 128 if tiles * -(-c_out // 128) >= SM_COUNT else 64
    return f"wgmma_n{bn}", bn


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The conv variant `gn_silu_conv(x, scale, bias, w, ...)` launches on the
    card: a pure function of shapes and dtype."""
    bsz, h, wd, _ = x.shape
    return kernel_plan(x.dtype, bsz, h, wd, w.shape[3])[0]


def stats_plan(hw: int, c: int, dtype: torch.dtype, aligned: bool = True) -> Tuple[int, int, int]:
    """(blocks a batch P, pixels a block, values a load) of the statistics
    kernel: about 8192 values a block, at most 1024 blocks a batch, and
    16-byte loads (8 bf16 or 4 fp32 values) where C and x's alignment allow,
    else scalar ones. A block's 256 threads cover the C / vec slots of a
    pixel row, a thread several slots in turn where there are more."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if not aligned or c % vec:
        vec = 1
    blocks = min(1024, max(1, -(-hw * c // 8192)))
    ppb = -(-hw // blocks)
    return -(-hw // ppb), ppb, vec


def group_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                 eps: float):
    """K4's statistics: (a, s), each (B, C) fp32, with x * a + s the
    GroupNorm affine. On a CUDA tensor the two statistics kernels (one read
    of x, no fp32 copy of it), on a CPU tensor `affine_from_stats`."""
    if x.device.type == "cpu":
        return affine_from_stats(x, scale, bias, groups, eps)
    bsz, h, wd, c = x.shape
    if scale.dtype != bias.dtype or scale.dtype not in (torch.float32, torch.bfloat16):
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.contiguous(), bias.contiguous()
    n_blocks, ppb, vec = stats_plan(h * wd, c, x.dtype, aligned=x.data_ptr() % 16 == 0)
    part = torch.empty((bsz, n_blocks, groups, 2), dtype=torch.float64, device=x.device)
    a = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    s = torch.empty_like(a)
    lib = _build.load("gn_conv")
    err = lib.xm_gn_affine(_build.ptr(x), _build.ptr(part), _build.ptr(scale), _build.ptr(bias),
                           _build.ptr(a), _build.ptr(s), bsz, h * wd, c, groups, n_blocks, ppb,
                           vec, int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
                           float(eps), _build.stream(x.device))
    _build.check(err, "gn_silu_conv statistics")
    group_affine.launches += 1
    return a, s


group_affine.launches = 0


def group_moments(x: torch.Tensor, groups: int) -> torch.Tensor:
    """K4's statistics without their affine: (B, G, 3) fp64 (count, mean,
    M2 = the sum of squared deviations) of x (B, H, W, C) per (batch,
    group), for a band whose moments merge with other ranks'
    (`affine_from_moments`). On a CUDA tensor the statistics kernel and a
    merge of its blocks' partials in fp64 (`gn_moments_kernel`); on a CPU
    tensor `moments_reference`. Differentiable in x: the backward is the
    plain version's VJP."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_moments: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_moments: unsupported dtype {x.dtype}")
    if x.ndim != 4 or groups <= 0 or x.shape[3] % groups:
        raise ValueError(f"group_moments: x {tuple(x.shape)} in {groups} groups")
    _build.require_contiguous("group_moments", x)
    _build.record("group_moments", x, groups)
    return _GroupMoments.apply(x, groups)


class _GroupMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.save_for_backward(x)
        ctx.groups = groups
        if x.device.type == "cpu":
            return moments_reference(x, groups)
        return _launch_moments(x, groups)

    @staticmethod
    def backward(ctx, g):
        groups = ctx.groups
        (gx,) = _build.plain_vjp(lambda x: moments_reference(x, groups), ctx.saved_tensors,
                                 ctx.needs_input_grad[:1], g)
        return gx, None


def _launch_moments(x: torch.Tensor, groups: int) -> torch.Tensor:
    mom, _ = _moments(x, groups)
    group_moments.launches += 1
    return mom


def _moments(x: torch.Tensor, groups: int):
    """`xm_gn_moments` on x (B, ..., C), contiguous: (B, G, 3) fp64 moments
    and the statistics' plan (`stats_plan`)."""
    bsz, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (bsz * c)
    plan = n_blocks, ppb, vec = stats_plan(hw, c, x.dtype, aligned=x.data_ptr() % 16 == 0)
    part = torch.empty((bsz, n_blocks, groups, 2), dtype=torch.float64, device=x.device)
    mom = torch.empty((bsz, groups, 3), dtype=torch.float64, device=x.device)
    lib = _build.load("gn_conv")
    err = lib.xm_gn_moments(_build.ptr(x), _build.ptr(part), _build.ptr(mom), bsz, hw, c,
                            groups, n_blocks, ppb, vec, int(x.dtype == torch.bfloat16),
                            _build.stream(x.device))
    _build.check(err, "group statistics")
    return mom, plan


group_moments.launches = 0


def centred_norm(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, eps: float) -> torch.Tensor:
    """(xf - mean) * (rsqrt(var + eps) * weight) + bias of xf (B, N, G, C/G)
    fp32 with mean and var (B, 1, G, 1): the plain GroupNorm's last pass. The
    parameters are promoted to fp32 inside the ops that read them; var is
    updated in place."""
    g, cg = xf.shape[2], xf.shape[3]
    mul = torch.rsqrt(var.add_(eps)) * weight.reshape(g, cg)
    return torch.addcmul(bias.reshape(g, cg), xf - mean, mul)


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                         eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """The models' plain GroupNorm over the last axis of x (B, ..., C),
    computed as flax computes it: fp32 statistics per (batch, group) in one
    pass, var = max(0, E[x^2] - E[x]^2), then `centred_norm`, cast back to
    x's type; `F.silu` of that where `silu`."""
    cg = x.shape[-1] // groups
    xf = x.float().reshape(x.shape[0], -1, groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True).sub_(mean.square()).clamp_(min=0.0)
    y = centred_norm(xf, mean, var, weight, bias, eps).reshape(x.shape).to(x.dtype)
    return F.silu(y) if silu else y


def records_grad(*tensors) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last axis of x (B, ..., C) in `groups` groups, SiLU
    after it where `silu`; returns x's shape and type.

    On a CUDA tensor (fp32 or bf16, contiguous) that autograd does not
    record, three launches: K4's statistics (`gn_stats_kernel`, one read of
    x in its own type) and their fp64 merge (`gn_moments_kernel`), then
    `gn_apply_kernel` (a second read of x, the centred form in fp32 with
    SiLU fused, one write in x's type); no fp32 copy of x. The statistics
    are Welford's with fp64 merges, within rounding of
    `group_norm_reference`'s one-pass ones. CPU tensors and calls autograd
    records take `group_norm_reference`, which is differentiable."""
    if x.ndim < 2 or groups <= 0 or x.shape[-1] % groups:
        raise ValueError(f"group_norm: x {tuple(x.shape)} in {groups} groups")
    c = x.shape[-1]
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group_norm: x {tuple(x.shape)} weight {tuple(weight.shape)} "
                         f"bias {tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("group_norm: all inputs must be on one device")
    if x.device.type != "cpu" and x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm: unsupported dtype {x.dtype}")
    _build.record("group_norm", x, weight, bias, groups, eps, silu)
    if x.device.type == "cpu" or records_grad(x, weight, bias):
        return group_norm_reference(x, weight, bias, groups, eps, silu)
    _build.require_contiguous("group_norm", x)
    if x.numel() == 0:
        return torch.empty_like(x)
    if weight.dtype != bias.dtype or weight.dtype not in (torch.float32, torch.bfloat16):
        weight, bias = weight.float(), bias.float()
    weight, bias = weight.contiguous(), bias.contiguous()
    mom, (n_blocks, ppb, vec) = _moments(x, groups)
    y = torch.empty_like(x)
    bsz = x.shape[0]
    err = _build.load("gn_conv").xm_gn_apply(
        _build.ptr(x), _build.ptr(mom), _build.ptr(weight), _build.ptr(bias), _build.ptr(y), bsz,
        x.numel() // (bsz * c), c, groups, n_blocks, ppb, vec, int(x.dtype == torch.bfloat16),
        int(weight.dtype == torch.bfloat16), int(silu), float(eps), _build.stream(x.device))
    _build.check(err, "group_norm")
    group_norm.launches += 1
    return y


group_norm.launches = 0


def kernel_params(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """K4's parameter layout for x of `dtype`, and b in fp32. bf16: w HWIO
    (3, 3, C, C_out) as (chunks, 9, 8, C_out_p, 8), [64-channel chunk][tap =
    3 dy + dx][8-channel group][output channel][8 channels], zero past C and
    C_out, with C_out_p = C_out rounded up to 128: the conv's shared-memory
    layout, so a block copies its (tap, chunk) slice as it lies. fp32: (tap,
    C_out, C)."""
    c, cout = w.shape[2], w.shape[3]
    if dtype != torch.bfloat16:
        wk = w.to(dtype).permute(0, 1, 3, 2).reshape(9, cout, c).contiguous()
        return wk, b.float().contiguous()
    chunks = -(-c // CHUNK)
    cout_p = -(-cout // COUT_PAD) * COUT_PAD
    wp = torch.zeros((9, chunks * CHUNK, cout_p), dtype=dtype, device=w.device)
    wp[:, :c, :cout] = w.to(dtype).reshape(9, c, cout)
    wk = wp.reshape(9, chunks, CHUNK // 8, 8, cout_p).permute(1, 0, 2, 4, 3).contiguous()
    return wk, b.float().contiguous()


def _params_shape(dtype: torch.dtype, c: int, cout: int) -> Tuple[int, ...]:
    if dtype != torch.bfloat16:
        return (9, cout, c)
    return (-(-c // CHUNK), 9, CHUNK // 8, -(-cout // COUT_PAD) * COUT_PAD, 8)


def gn_silu_conv(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, groups: int = 32, eps: float = 1e-6,
                 params=None) -> torch.Tensor:
    """GroupNorm(groups) -> SiLU -> 3x3 SAME conv + bias: kernel K4 on CUDA
    tensors, the plain version on CPU ones (same checks on both).

    x (B, H, W, C) fp32 or bf16, contiguous; scale, bias (C,); w (3, 3, C,
    C_out) HWIO in any layout; b (C_out,). `params`, if given, is
    `kernel_params(w, b, x.dtype)` made once by the caller, which the kernel
    then reads in place of w and b. Returns (B, H, W, C_out) in x's type."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_silu_conv: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gn_silu_conv: unsupported dtype {x.dtype}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"gn_silu_conv: x {tuple(x.shape)} w {tuple(w.shape)}")
    c, cout = x.shape[3], w.shape[3]
    if tuple(w.shape[:3]) != (3, 3, c) or tuple(scale.shape) != (c,) \
            or tuple(bias.shape) != (c,) or tuple(b.shape) != (cout,):
        raise ValueError(
            f"gn_silu_conv: x {tuple(x.shape)} w {tuple(w.shape)} scale {tuple(scale.shape)} "
            f"bias {tuple(bias.shape)} b {tuple(b.shape)}"
        )
    if groups <= 0 or c % groups:
        raise ValueError(f"gn_silu_conv: {c} channels do not split into {groups} groups")
    if any(t.device != x.device for t in (scale, bias, w, b)):
        raise ValueError("gn_silu_conv: all inputs must be on one device")
    if not all(t.is_floating_point() for t in (scale, bias, w, b)):
        raise TypeError("gn_silu_conv: scale, bias, w and b must be floating point")
    _build.require_contiguous("gn_silu_conv", x)
    _build.record("gn_silu_conv", x, scale, bias, w, b, groups, eps)
    return _GnSiluConv.apply(x, scale, bias, w, b, groups, eps, params)


class _GnSiluConv(torch.autograd.Function):
    """K4 with the plain version's VJP as its backward (the JAX package's
    `_gn_silu_conv_fused`): gradients for x, the norm's scale and bias and
    the raw conv weight and bias; the prepared `params` (the kernel's
    layout of w and b) take none."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, b, groups, eps, params):
        ctx.save_for_backward(x, scale, bias, w, b)
        ctx.groups, ctx.eps = groups, eps
        if x.device.type == "cpu":
            return gn_silu_conv_reference(x, scale, bias, w, b, groups, eps)
        return _launch(x, scale, bias, w, b, groups, eps, params)

    @staticmethod
    def backward(ctx, g):
        groups, eps = ctx.groups, ctx.eps
        grads = _build.plain_vjp(
            lambda *a: gn_silu_conv_reference(*a, groups, eps), ctx.saved_tensors,
            ctx.needs_input_grad[:5], g)
        return (*grads, None, None, None)


def affine_silu_conv(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, params=None) -> torch.Tensor:
    """K4's conv given its affine: SiLU(x a + s) -> 3x3 SAME conv + bias, the
    activation zero outside x's rows and columns. x (B, H, W, C) fp32 or
    bf16, contiguous (a band with its neighbours' raw edge rows); a, s (B,
    C) fp32; w, b and `params` as `gn_silu_conv` takes them. Kernel K4's
    conv on CUDA tensors, `affine_silu_conv_reference` on CPU ones;
    differentiable in x, a, s, w and b (the plain version's VJP)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"affine_silu_conv: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"affine_silu_conv: unsupported dtype {x.dtype}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"affine_silu_conv: x {tuple(x.shape)} w {tuple(w.shape)}")
    bsz, c, cout = x.shape[0], x.shape[3], w.shape[3]
    if tuple(w.shape[:3]) != (3, 3, c) or tuple(a.shape) != (bsz, c) \
            or tuple(s.shape) != (bsz, c) or tuple(b.shape) != (cout,):
        raise ValueError(f"affine_silu_conv: x {tuple(x.shape)} a {tuple(a.shape)} "
                         f"s {tuple(s.shape)} w {tuple(w.shape)} b {tuple(b.shape)}")
    if a.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError("affine_silu_conv: a and s must be fp32")
    if any(t.device != x.device for t in (a, s, w, b)):
        raise ValueError("affine_silu_conv: all inputs must be on one device")
    _build.require_contiguous("affine_silu_conv", x, a, s)
    _build.record("affine_silu_conv", x, a, s, w, b)
    return _AffineSiluConv.apply(x, a, s, w, b, params)


class _AffineSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, s, w, b, params):
        ctx.save_for_backward(x, a, s, w, b)
        if x.device.type == "cpu":
            return affine_silu_conv_reference(x, a, s, w, b)
        out = _conv(x, a, s, w, b, params)
        affine_silu_conv.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        grads = _build.plain_vjp(affine_silu_conv_reference, ctx.saved_tensors,
                                 ctx.needs_input_grad[:5], g)
        return (*grads, None)


affine_silu_conv.launches = 0


def _launch(x, scale, bias, w, b, groups, eps, params) -> torch.Tensor:
    a, s = group_affine(x, scale, bias, groups, eps)
    out = _conv(x, a, s, w, b, params)
    gn_silu_conv.launches += 1
    return out


def _conv(x, a, s, w, b, params) -> torch.Tensor:
    """The conv kernel on x with the affine (a, s)."""
    c, cout = x.shape[3], w.shape[3]
    bsz, h, wd, _ = x.shape
    if params is None:
        params = kernel_params(w, b, x.dtype)
    wk, bf = params
    if tuple(wk.shape) != _params_shape(x.dtype, c, cout) or wk.dtype != x.dtype \
            or not wk.is_contiguous() or bf.dtype != torch.float32 or tuple(bf.shape) != (cout,) \
            or wk.device != x.device or bf.device != x.device:
        raise ValueError(f"gn_silu_conv: params {tuple(wk.shape)} {wk.dtype} {bf.dtype} are "
                         f"not kernel_params of w {tuple(w.shape)} for {x.dtype}")
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("gn_conv")
    args = (_build.ptr(x), _build.ptr(a), _build.ptr(s), _build.ptr(wk), _build.ptr(bf),
            _build.ptr(out), bsz, h, wd, c, cout)
    if x.dtype == torch.bfloat16:
        _, bn = kernel_plan(x.dtype, bsz, h, wd, cout)
        vec = int(c % 8 == 0 and x.data_ptr() % 16 == 0)
        err = lib.xm_gn_silu_conv_bf16(*args, bn, vec, _build.stream(x.device))
    else:
        err = lib.xm_gn_silu_conv_f32(*args, _build.stream(x.device))
    _build.check(err, "gn_silu_conv")
    return out


gn_silu_conv.launches = 0


def _bind(lib):
    lib.xm_gn_silu_conv_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.xm_gn_silu_conv_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.xm_gn_affine.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    lib.xm_gn_moments.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.xm_gn_apply.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.xm_gn_silu_conv_f32, lib.xm_gn_silu_conv_bf16, lib.xm_gn_affine,
               lib.xm_gn_moments, lib.xm_gn_apply):
        fn.restype = ctypes.c_int


_build.BINDERS["gn_conv"] = _bind
