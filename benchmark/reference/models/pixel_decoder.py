"""MSDeformAttn pixel decoder (deformable-DETR encoder + FPN lateral).

Counterpart of `xmask3d_tpu/models/pixel_decoder.py`: deformable
self-attention layers over the s3/s4/s5 pyramid (256 ch, 8 heads, 4 points,
FFN 1024) with sampling through kernel K3, then one FPN step down to the
stride-4 `mask_features`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.device import device_constant
from benchmark.reference.models.layers import Conv, GroupNorm, LayerNorm, resize
from benchmark.reference.ops.deform_attn import ms_deform_attn


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> np.ndarray:
    """Normalised DETR sine embedding (h, w, 2 * num_pos_feats): y then x."""
    eps, scale = 1e-6, 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = temperature ** (2 * (np.arange(num_pos_feats, dtype=np.float32) // 2) / num_pos_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=-1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=-1)
    return np.concatenate([pos_y.reshape(h, w, -1), pos_x.reshape(h, w, -1)], axis=-1)


def sine_embedding(h: int, w: int, num_pos_feats: int, device) -> torch.Tensor:
    """`position_embedding_sine` as a float32 tensor on `device`, built once."""
    return device_constant(("sine_embedding", h, w, num_pos_feats), device,
                           lambda: torch.from_numpy(position_embedding_sine(h, w, num_pos_feats)))


def reference_points(shapes) -> np.ndarray:
    """(sum h * w, 2) normalised (x, y) pixel centres of every level."""
    ref = []
    for hh, ww in shapes:
        ys = (np.arange(hh, dtype=np.float32) + 0.5) / hh
        xs = (np.arange(ww, dtype=np.float32) + 0.5) / ww
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        ref.append(np.stack([gx, gy], -1).reshape(hh * ww, 2))
    return np.concatenate(ref, 0)


def _offsets_init(heads: int, levels: int, points: int) -> np.ndarray:
    """Directional grid init of the sampling-offset bias."""
    thetas = np.arange(heads, dtype=np.float64) * (2.0 * np.pi / heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, levels, points, 1))
    for i in range(points):
        grid[:, :, i, :] *= i + 1
    return grid.astype(np.float32)


class MSDeformAttnLayer(nn.Module):
    def __init__(self, d_model: int = 256, heads: int = 8, points: int = 4,
                 levels: int = 3, ffn_dim: int = 1024):
        super().__init__()
        self.heads, self.points, self.levels = heads, points, levels
        self.sampling_offsets = nn.Linear(d_model, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d_model, heads * levels * points)
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(_offsets_init(heads, levels, points).reshape(-1)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, reference_points, spatial_shapes):
        b, n, c = src.shape
        h, l, p = self.heads, self.levels, self.points
        q = src + pos
        offsets = self.sampling_offsets(q).reshape(b, n, h, l, p, 2)
        attn_w = torch.softmax(self.attention_weights(q).reshape(b, n, h, l * p), dim=-1)
        attn_w = attn_w.reshape(b, n, h, l, p)
        value = self.value_proj(src).reshape(b, n, h, c // h)
        wh = device_constant(
            ("deform_level_wh", tuple(spatial_shapes)), src.device,
            lambda: torch.tensor([[ww, hh] for hh, ww in spatial_shapes], dtype=torch.float32))
        loc = reference_points[:, :, None, :, None, :] + offsets.float() / wh[None, None, None, :, None, :]
        out = self.output_proj(ms_deform_attn(value, spatial_shapes, loc, attn_w.float()))
        src = self.norm1(src + out)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


class MSDeformAttnPixelDecoder(nn.Module):
    """Encoder over (s3, s4, s5) + FPN step to stride-4 mask features.
    forward(features) -> (mask_features (B, H/4, W/4, mask_dim),
    [stride 32, stride 16, stride 8] maps)."""

    def __init__(self, in_channels: int = 512, conv_dim: int = 256, mask_dim: int = 256,
                 heads: int = 8, points: int = 4, enc_layers: int = 6, ffn_dim: int = 1024,
                 transformer_in_features: Sequence[str] = ("s3", "s4", "s5")):
        super().__init__()
        self.conv_dim, self.enc_layers = conv_dim, enc_layers
        self.names = list(transformer_in_features)[::-1]  # s5, s4, s3
        for i in range(len(self.names)):
            setattr(self, f"input_proj_{i}", Conv(in_channels, conv_dim, 1))
            setattr(self, f"input_norm_{i}", GroupNorm(conv_dim))
            setattr(self, f"level_embed_{i}", nn.Parameter(torch.randn(conv_dim)))
        for li in range(enc_layers):
            setattr(self, f"encoder_layer_{li}",
                    MSDeformAttnLayer(conv_dim, heads, points, len(self.names), ffn_dim))
        self.adapter_1 = Conv(in_channels, conv_dim, 1, bias=False)
        self.adapter_norm_1 = GroupNorm(conv_dim)
        self.layer_1 = Conv(conv_dim, conv_dim, 3, padding=1, bias=False)
        self.layer_norm_1 = GroupNorm(conv_dim)
        self.mask_features = Conv(conv_dim, mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor]):
        srcs, poss, shapes = [], [], []
        for i, name in enumerate(self.names):
            x = getattr(self, f"input_norm_{i}")(getattr(self, f"input_proj_{i}")(features[name]))
            b, hh, ww, c = x.shape
            pos = sine_embedding(hh, ww, self.conv_dim // 2, x.device)
            level_embed = getattr(self, f"level_embed_{i}")
            shapes.append((hh, ww))
            srcs.append(x.reshape(b, hh * ww, c))
            poss.append((pos.to(x.dtype).reshape(1, hh * ww, c) + level_embed).to(x.dtype))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat([p.expand(s.shape) for p, s in zip(poss, srcs)], dim=1)
        ref = device_constant(("deform_reference_points", tuple(shapes)), src.device,
                              lambda: torch.from_numpy(reference_points(shapes)))
        ref = ref[None, :, None, :].expand(src.shape[0], ref.shape[0], len(shapes), 2)
        for li in range(self.enc_layers):
            src = getattr(self, f"encoder_layer_{li}")(src, pos, ref, shapes)
        outs: List[torch.Tensor] = []
        off, b = 0, src.shape[0]
        for hh, ww in shapes:
            outs.append(src[:, off:off + hh * ww].reshape(b, hh, ww, self.conv_dim))
            off += hh * ww
        x2 = features["s2"]
        lateral = self.adapter_norm_1(self.adapter_1(x2))
        up = resize(outs[-1], (x2.shape[1], x2.shape[2]), (1, 2), "bilinear")
        y = F.relu(self.layer_norm_1(self.layer_1(lateral + up)))
        return self.mask_features(y), outs
