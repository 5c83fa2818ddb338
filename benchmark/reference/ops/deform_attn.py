"""Multi-scale deformable attention sampling, plain:

    out[b, q, h] = sum_level sum_point aw * bilinear(value_level, loc * size - 0.5)

with grid_sample(align_corners=False, padding_mode="zeros") semantics; a
sample whose corner (floor(x), floor(y)) lies outside [-1, size) is zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from benchmark.reference.ops.record import record


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



def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights) -> torch.Tensor:
    """The pixel decoder's sampling: its plain formulation."""
    record("deform_attn", value=value, spatial_shapes=spatial_shapes, loc=sampling_locations,
           aw=attention_weights)
    return ms_deform_attn_reference(value, spatial_shapes, sampling_locations, attention_weights)
