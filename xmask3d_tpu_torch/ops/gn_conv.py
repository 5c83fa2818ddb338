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


def _launch(x, scale, bias, w, b, groups, eps, params) -> torch.Tensor:
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
    a, s = group_affine(x, scale, bias, groups, eps)
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
    gn_silu_conv.launches += 1
    return out


gn_silu_conv.launches = 0


def _bind(lib):
    lib.xm_gn_silu_conv_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.xm_gn_silu_conv_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.xm_gn_affine.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.xm_gn_silu_conv_f32, lib.xm_gn_silu_conv_bf16, lib.xm_gn_affine):
        fn.restype = ctypes.c_int


_build.BINDERS["gn_conv"] = _bind
