"""Stable Diffusion v1 denoising UNet, NHWC, with feature taps, plain.
The forward returns the taps (the concatenated [h, skip] inputs of the
listed output blocks) and stops once the last one is taken; with
`full=True` it runs every output block and the output head and returns
(eps, taps).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import (
    Conv, GroupNorm, LayerNorm, RematBlock, upsample2x_nearest)
from benchmark.reference.ops.flash_attention import attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    attention_levels: Sequence[int] = (0, 1, 2)
    num_heads: int = 8
    context_dim: int = 768


UNET_TINY = UNetConfig(
    model_channels=32, ch_mult=(1, 1, 2, 2), num_res_blocks=2,
    attention_levels=(0, 1, 2), num_heads=2, context_dim=24,
)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNetResBlock(RematBlock):
    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm(in_ch)
        self.in_conv = Conv(in_ch, out_ch, 3, padding=1)
        self.emb_proj = nn.Linear(emb_dim, out_ch)
        self.out_norm = GroupNorm(out_ch)
        self.out_conv = Conv(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.skip = Conv(in_ch, out_ch, 1)

    def body(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, None, None, :]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention; Q/K/V projections kept as separate bias-free
    `to_q`/`to_k`/`to_v`."""

    def __init__(self, c: int, heads: int, ctx_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.head_dim = heads, c // heads
        cin = c if ctx_dim is None else ctx_dim
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(cin, c, bias=False)
        self.to_v = nn.Linear(cin, c, bias=False)
        self.to_out = nn.Linear(c, c)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, t = x.shape[:2]
        d = self.head_dim
        h = self.to_q.weight.shape[0] // d

        def split(z):
            return z.reshape(z.shape[0], z.shape[1], h, d).transpose(1, 2).contiguous()

        q = split(self.to_q(x))
        k, v = split(self.to_k(ctx)), split(self.to_v(ctx))
        out = attention(q, k, v).transpose(1, 2).reshape(b, t, h * d)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, c: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * out_dim)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b, approximate="tanh")  # jax.nn.gelu's default


class BasicTransformerBlock(nn.Module):
    def __init__(self, c: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(c)
        self.attn1 = CrossAttention(c, heads)
        self.norm2 = LayerNorm(c)
        self.attn2 = CrossAttention(c, heads, ctx_dim)
        self.norm3 = LayerNorm(c)
        self.ff_geglu = GEGLU(c, 4 * c)
        self.ff_out = nn.Linear(4 * c, c)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        y = self.norm3(x)
        return x + self.ff_out(self.ff_geglu(y))


class SpatialTransformer(RematBlock):
    def __init__(self, c: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.proj_in = Conv(c, c, 1)
        self.block_0 = BasicTransformerBlock(c, heads, ctx_dim)
        self.proj_out = Conv(c, c, 1)

    def body(self, x, context):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        y = self.block_0(y, context).reshape(b, h, w, c)
        return x + self.proj_out(y)


class SDUNet(nn.Module):
    """Each UNetResBlock and SpatialTransformer is a RematBlock: the JAX
    package's `nn.remat` on the same blocks."""

    def __init__(self, cfg: UNetConfig = UNetConfig(), tap_indices: Sequence[int] = (2, 5, 8, 11)):
        super().__init__()
        self.cfg, self.tap_indices = cfg, tuple(tap_indices)
        mc, ed, ctx = cfg.model_channels, 4 * cfg.model_channels, cfg.context_dim
        self.time_embed_0 = nn.Linear(mc, ed)
        self.time_embed_2 = nn.Linear(ed, ed)
        self.in_conv = Conv(cfg.in_channels, mc, 3, padding=1)
        n_lv = len(cfg.ch_mult)
        ch, hs_ch = mc, [mc]
        for lv, mult in enumerate(cfg.ch_mult):
            for i in range(cfg.num_res_blocks):
                setattr(self, f"down_{lv}_res_{i}", UNetResBlock(ch, mc * mult, ed))
                ch = mc * mult
                if lv in cfg.attention_levels:
                    setattr(self, f"down_{lv}_attn_{i}", SpatialTransformer(ch, cfg.num_heads, ctx))
                hs_ch.append(ch)
            if lv != n_lv - 1:
                setattr(self, f"down_{lv}_downsample", Conv(ch, ch, 3, stride=2, padding=1))
                hs_ch.append(ch)
        self.mid_res_0 = UNetResBlock(ch, ch, ed)
        self.mid_attn = SpatialTransformer(ch, cfg.num_heads, ctx)
        self.mid_res_1 = UNetResBlock(ch, ch, ed)
        for lv in reversed(range(n_lv)):
            for i in range(cfg.num_res_blocks + 1):
                cat = ch + hs_ch.pop()
                setattr(self, f"up_{lv}_res_{i}", UNetResBlock(cat, mc * cfg.ch_mult[lv], ed))
                ch = mc * cfg.ch_mult[lv]
                if lv in cfg.attention_levels:
                    setattr(self, f"up_{lv}_attn_{i}", SpatialTransformer(ch, cfg.num_heads, ctx))
                if lv != 0 and i == cfg.num_res_blocks:
                    setattr(self, f"up_{lv}_upsample", Conv(ch, ch, 3, padding=1))
        self.out_norm = GroupNorm(ch)
        self.out_conv = Conv(ch, cfg.out_channels, 3, padding=1)

    def forward(self, x, t, context, cond_emb=None, full: bool = False):
        """x (B, h, w, 4) noisy latent, t (B,), context (B, T, ctx) ->
        the output-block taps; with `full`, (eps (B, h, w, 4), taps)."""
        cfg = self.cfg
        dt = self.time_embed_0.weight.dtype
        emb = self.time_embed_0(timestep_embedding(t, cfg.model_channels).to(dt))
        emb = self.time_embed_2(F.silu(emb))
        if cond_emb is not None:
            emb = emb + cond_emb.to(emb.dtype)
        n_lv = len(cfg.ch_mult)
        h = self.in_conv(x.to(dt))
        hs = [h]
        for lv in range(n_lv):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{lv}_res_{i}")(h, emb)
                if lv in cfg.attention_levels:
                    h = getattr(self, f"down_{lv}_attn_{i}")(h, context)
                hs.append(h)
            if lv != n_lv - 1:
                h = getattr(self, f"down_{lv}_downsample")(h)
                hs.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, emb), context), emb)
        taps: List[torch.Tensor] = []
        last = max(self.tap_indices)
        out_idx = 0
        for lv in reversed(range(n_lv)):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                if out_idx in self.tap_indices:
                    taps.append(h)
                    if out_idx == last and not full:
                        return taps
                h = getattr(self, f"up_{lv}_res_{i}")(h, emb)
                if lv in cfg.attention_levels:
                    h = getattr(self, f"up_{lv}_attn_{i}")(h, context)
                if lv != 0 and i == cfg.num_res_blocks:
                    h = getattr(self, f"up_{lv}_upsample")(upsample2x_nearest(h))
                out_idx += 1
        if not full:
            return taps
        return self.out_conv(F.silu(self.out_norm(h))), taps
