"""Multi-scale deformable attention sampling: kernel K3 and its plain version.

Counterpart of `xmask3d_tpu/ops/deform_attn.py`:

    out[b, q, h] = sum_level sum_point aw * bilinear(value_level, loc * size - 0.5)

with grid_sample(align_corners=False, padding_mode="zeros") semantics; a
sample whose corner (floor(x), floor(y)) lies outside [-1, size) is zero.
bf16 head dims of 8 times a power of two (up to 256) take the vector
kernel, 16-byte gathers with lanes over (sample, 8-channel slice); fp32 and
the other widths the scalar one, lanes over channels (`kernel_plan`). The
wrapper is differentiable in value, locations and weights: its backward is
the plain version's VJP.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from xmask3d_tpu_torch.ops import _build


def ms_deform_attn_reference(
    value: torch.Tensor,  # (B, sum_HW, heads, d)
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, heads, levels, points, 2)
    attention_weights: torch.Tensor,  # (B, Lq, heads, levels, points)
) -> torch.Tensor:
    """Plain four-tap gather formulation; fp32 accumulation.
    Returns (B, Lq, heads * d) in value's dtype."""
    b, _, heads, d = value.shape
    lq, npts = sampling_locations.shape[1], sampling_locations.shape[4]
    out = torch.zeros((b, lq, heads, d), dtype=torch.float32, device=value.device)
    start = 0
    for li, (hh, ww) in enumerate(spatial_shapes):
        v = value[:, start:start + hh * ww].float()  # (B, HW, heads, d)
        start += hh * ww
        v = v.permute(0, 2, 1, 3).reshape(b * heads, hh * ww, d)
        loc = sampling_locations[:, :, :, li].float()  # (B, Lq, heads, P, 2)
        px = (loc[..., 0] * ww - 0.5).permute(0, 2, 1, 3).reshape(b * heads, lq * npts)
        py = (loc[..., 1] * hh - 0.5).permute(0, 2, 1, 3).reshape(b * heads, lq * npts)
        x0, y0 = torch.floor(px), torch.floor(py)
        dx, dy = px - x0, py - y0
        inb = (x0 >= -1) & (x0 < ww) & (y0 >= -1) & (y0 < hh)
        sampled = torch.zeros((b * heads, lq * npts, d), dtype=torch.float32, device=value.device)
        for ox, oy, wt in ((0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
                           (0, 1, (1 - dx) * dy), (1, 1, dx * dy)):
            xi, yi = x0 + ox, y0 + oy
            ok = inb & (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
            flat = (yi.clamp(0, hh - 1) * ww + xi.clamp(0, ww - 1)).long()
            g = torch.gather(v, 1, flat[..., None].expand(-1, -1, d))
            sampled += torch.where(ok, wt, torch.zeros_like(wt))[..., None] * g
        sampled = sampled.reshape(b, heads, lq, npts, d)
        wgt = attention_weights[:, :, :, li].float().permute(0, 2, 1, 3)  # (B, heads, Lq, P)
        out += torch.einsum("bhqpd,bhqp->bqhd", sampled, wgt)
    return out.reshape(b, lq, heads * d).to(value.dtype)


VEC_LANES = (1, 2, 4, 8, 16, 32)  # lanes a value row: d / 8
UNROLLED = (32, 3, 4)  # the pixel decoder's head dim, levels and points: unrolled


def kernel_plan(dtype: torch.dtype, d: int, n_levels: int, n_points: int,
                aligned: bool = True) -> Tuple[str, int, bool]:
    """(variant name, lanes a value row or 0 for the scalar kernel, unrolled)
    of the kernel a call takes. bf16 with d / 8 a power of two up to 32 and
    value aligned to 16 bytes runs the vector kernel, with everything
    unrolled at the pixel decoder's d = 32, 3 levels x 4 points; all else
    the scalar kernel."""
    lr = d // 8
    if dtype != torch.bfloat16 or d % 8 or lr not in VEC_LANES or not aligned:
        return f"scalar_{'bf16' if dtype == torch.bfloat16 else 'fp32'}", 0, False
    unrolled = (d, n_levels, n_points) == UNROLLED
    return f"vec_d{d}_{'l3p4' if unrolled else 'any'}", lr, unrolled


def variant(value: torch.Tensor, loc: torch.Tensor) -> str:
    """The variant `ms_deform_attn(value, shapes, loc, aw)` launches on the
    card: a pure function of shapes, dtype and value's alignment."""
    return kernel_plan(value.dtype, value.shape[3], loc.shape[3], loc.shape[4],
                       value.data_ptr() % 16 == 0)[0]


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Kernel K3 on CUDA tensors, the plain version on CPU ones (same checks
    on both)."""
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ms_deform_attn: unsupported dtype {value.dtype}")
    b, s_total, heads, _ = value.shape
    _, _, lh, n_lv, _, two = sampling_locations.shape
    if lh != heads or two != 2 or n_lv != len(spatial_shapes) \
            or attention_weights.shape != sampling_locations.shape[:5] \
            or sampling_locations.shape[0] != b:
        raise ValueError("ms_deform_attn: shapes of value / locations / weights disagree")
    if sum(h * w for h, w in spatial_shapes) != s_total:
        raise ValueError("ms_deform_attn: spatial shapes do not cover value")
    if sampling_locations.device != value.device or attention_weights.device != value.device:
        raise ValueError("ms_deform_attn: all tensors must be on one device")
    loc, aw = sampling_locations, attention_weights
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError("ms_deform_attn: locations and weights must be float32")
    _build.require_contiguous("ms_deform_attn", value, loc, aw)
    _build.record("deform_attn", value, spatial_shapes, loc, aw)
    return _DeformAttn.apply(value, tuple(spatial_shapes), loc, aw)


class _DeformAttn(torch.autograd.Function):
    """K3 with the plain version's VJP as its backward (the JAX package's
    `_ms_deform_attn_hybrid`); the forward saves only its inputs."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, aw):
        ctx.save_for_backward(value, loc, aw)
        ctx.spatial_shapes = spatial_shapes
        if value.device.type == "cpu":
            return ms_deform_attn_reference(value, spatial_shapes, loc, aw)
        return _launch(value, spatial_shapes, loc, aw)

    @staticmethod
    def backward(ctx, g):
        shapes = ctx.spatial_shapes
        gv, gl, ga = _build.plain_vjp(
            lambda v, l, a: ms_deform_attn_reference(v, shapes, l, a), ctx.saved_tensors,
            (ctx.needs_input_grad[0], *ctx.needs_input_grad[2:]), g)
        return gv, None, gl, ga


def _launch(value, spatial_shapes, loc, aw) -> torch.Tensor:
    b, s_total, heads, d = value.shape
    _, lq, _, n_lv, npts, _ = loc.shape
    out = torch.empty((b, lq, heads * d), dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * n_lv))(*[int(x) for hw in spatial_shapes for x in hw])
    lib = _build.load("deform_attn")
    args = (_build.ptr(value), _build.ptr(loc), _build.ptr(aw), _build.ptr(out), shapes,
            b, lq, heads, d, n_lv, npts, s_total)
    if value.dtype == torch.bfloat16:
        _, lr, unrolled = kernel_plan(value.dtype, d, n_lv, npts, value.data_ptr() % 16 == 0)
        err = lib.xm_deform_attn_bf16(*args, lr, int(unrolled), _build.stream(value.device))
    else:
        err = lib.xm_deform_attn_f32(*args, _build.stream(value.device))
    _build.check(err, "ms_deform_attn")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0


def _bind(lib):
    for name, ints in (("xm_deform_attn_f32", 7), ("xm_deform_attn_bf16", 9)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] \
            + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_build.BINDERS["deform_attn"] = _bind
