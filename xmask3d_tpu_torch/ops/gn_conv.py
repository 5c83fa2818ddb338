"""GroupNorm -> SiLU -> 3x3 SAME conv from the raw activation: kernel K4 and
its plain version.

Counterpart of `xmask3d_tpu/ops/gn_conv.py`, used by the VAE resblocks when
`fused_gn` is on. The group statistics are a plain reduction outside the
kernel (`affine_from_stats`, as the JAX package leaves them to XLA); the
kernel applies the per-channel affine and SiLU while it stages its input
tile and runs the conv, so the normalised activation never reaches device
memory. Layout is the JAX contract: x (B, H, W, C), w HWIO (3, 3, C, C_out).
The port's kernel takes any shape, so there is no shape gate; on a CPU
tensor the plain version runs.
"""

from __future__ import annotations

import ctypes

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
    the GroupNorm affine. The statistics are stable ones in fp32 (Welford's
    in one pass of `var_mean`), equal to the plain version's two-pass ones
    up to rounding."""
    bsz, h, wd, c = x.shape
    cg = c // groups
    xf = x.float().reshape(bsz, h * wd, groups, cg)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0)  # (B, G)
    # (B, G, 1) against the (G, C/G) parameters, promoted to fp32 in the op
    a = torch.rsqrt(var.add_(eps)).unsqueeze(2) * scale.reshape(groups, cg)
    s = torch.addcmul(bias.reshape(groups, cg), mean.unsqueeze(2), a, value=-1.0)
    return a.reshape(bsz, c), s.reshape(bsz, c)


def kernel_params(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """K4's parameter layout: w HWIO (3, 3, C, C_out) as (tap, C_out, C) in
    `dtype`, each output channel's taps with the channels innermost, and b
    in fp32."""
    wk = w.to(dtype).permute(0, 1, 3, 2).reshape(9, w.shape[3], w.shape[2]).contiguous()
    return wk, b.float().contiguous()


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
    if x.device.type == "cpu":
        return gn_silu_conv_reference(x, scale, bias, w, b, groups, eps)
    bsz, h, wd, _ = x.shape
    if params is None:
        params = kernel_params(w, b, x.dtype)
    wk, bf = params
    if tuple(wk.shape) != (9, cout, c) or wk.dtype != x.dtype or not wk.is_contiguous() \
            or bf.dtype != torch.float32 or tuple(bf.shape) != (cout,) \
            or wk.device != x.device or bf.device != x.device:
        raise ValueError(f"gn_silu_conv: params {tuple(wk.shape)} {wk.dtype} {bf.dtype} are "
                         f"not kernel_params of w {tuple(w.shape)} for {x.dtype}")
    a, s = affine_from_stats(x, scale, bias, groups, eps)
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("gn_conv")
    fn = lib.xm_gn_silu_conv_bf16 if x.dtype == torch.bfloat16 else lib.xm_gn_silu_conv_f32
    err = fn(_build.ptr(x), _build.ptr(a), _build.ptr(s), _build.ptr(wk), _build.ptr(bf),
             _build.ptr(out), bsz, h, wd, c, cout, _build.stream(x.device))
    _build.check(err, "gn_silu_conv")
    gn_silu_conv.launches += 1
    return out


gn_silu_conv.launches = 0


def _bind(lib):
    for name in ("xm_gn_silu_conv_f32", "xm_gn_silu_conv_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_build.BINDERS["gn_conv"] = _bind
