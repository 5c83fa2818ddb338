"""Stable Diffusion v1 VAE (AutoencoderKL), NHWC, with feature taps, plain:
GroupNorm -> SiLU -> conv resblocks and single-head mid-block attention.
The encoder and decoder return the inputs of the flattened blocks listed in
their tap indices. `decode_taps` stops the decoder once its last tap is
taken, since the eval path uses only the taps; `decode` runs every level
and the output head and returns (rgb, taps).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import Conv, GroupNorm, RematBlock, upsample2x_nearest
from benchmark.reference.ops.flash_attention import attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    scale_factor: float = 0.18215


VAE_TINY = VAEConfig(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=2)


class ResnetBlock(RematBlock):
    """Two GroupNorm -> SiLU -> conv3x3 stages and a residual."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv(in_ch, out_ch, 1)

    def body(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(RematBlock):
    """Single-head spatial self-attention over H x W (VAE mid block)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q = Conv(c, c, 1)
        self.k = Conv(c, c, 1)
        self.v = Conv(c, c, 1)
        self.proj_out = Conv(c, c, 1)

    def body(self, x):
        b, h, w, c = x.shape
        y = self.norm(x)
        q, k, v = (p(y).reshape(b, 1, h * w, c).contiguous() for p in (self.q, self.k, self.v))
        out = attention(q, k, v).reshape(b, h, w, c)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2)

    def forward(self, x):
        # SD's asymmetric (0, 1) padding for the strided conv
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample2x_nearest(x))


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, tap_indices: Sequence[int] = (5, 7)):
        super().__init__()
        c = cfg
        self.cfg, self.tap_indices = cfg, tuple(tap_indices)
        self.conv_in = Conv(3, c.ch, 3, padding=1)
        ch = c.ch
        for i_level, mult in enumerate(c.ch_mult):
            for i_block in range(c.num_res_blocks):
                setattr(self, f"down_{i_level}_block_{i_block}", ResnetBlock(ch, c.ch * mult))
                ch = c.ch * mult
            if i_level != len(c.ch_mult) - 1:
                setattr(self, f"down_{i_level}_downsample", Downsample(ch))
        self.mid_block_1 = ResnetBlock(ch, ch)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch)
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, 2 * c.z_channels, 3, padding=1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        c = self.cfg
        taps, flat_idx = [], 0
        h = self.conv_in(x)
        for i_level in range(len(c.ch_mult)):
            for i_block in range(c.num_res_blocks):
                if flat_idx in self.tap_indices:
                    taps.append(h)
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h)
                flat_idx += 1
            if i_level != len(c.ch_mult) - 1:
                h = getattr(self, f"down_{i_level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = self.norm_out(h)
        h = h * torch.sigmoid(h)
        return self.conv_out(h), taps


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, tap_indices: Sequence[int] = (2, 5)):
        super().__init__()
        c = cfg
        self.cfg, self.tap_indices = cfg, tuple(tap_indices)
        n_lv = len(c.ch_mult)
        block_in = c.ch * c.ch_mult[-1]
        self.conv_in = Conv(c.z_channels, block_in, 3, padding=1)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        ch = block_in
        for i_level in reversed(range(n_lv)):
            out_ch = c.ch * c.ch_mult[i_level]
            for i_block in range(c.num_res_blocks + 1):
                setattr(self, f"up_{i_level}_block_{i_block}", ResnetBlock(ch, out_ch))
                ch = out_ch
            if i_level != 0:
                setattr(self, f"up_{i_level}_upsample", Upsample(ch))
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, 3, 3, padding=1)

    def forward(self, z, full: bool = False):
        """The decoder taps, stopping once the last one is taken; with
        `full`, (rgb (B, H, W, 3), taps) after every level, `norm_out`
        (plain GroupNorm), SiLU and `conv_out`."""
        c = self.cfg
        taps, flat_idx = [], 0
        last = max(self.tap_indices)
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i_level in reversed(range(len(c.ch_mult))):
            for i_block in range(c.num_res_blocks + 1):
                if flat_idx in self.tap_indices:
                    taps.append(h)
                    if flat_idx == last and not full:
                        return taps
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h)
                flat_idx += 1
            if i_level != 0:
                h = getattr(self, f"up_{i_level}_upsample")(h)
        if not full:
            return taps
        return self.conv_out(F.silu(self.norm_out(h))), taps


class AutoencoderKL(nn.Module):
    """VAE with quant/post-quant 1x1 projections and mean latents."""

    def __init__(self, cfg: VAEConfig, encoder_taps=(5, 7), decoder_taps=(2, 5)):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg, encoder_taps)
        self.decoder = VAEDecoder(cfg, decoder_taps)
        self.quant_conv = nn.Linear(2 * cfg.z_channels, 2 * cfg.embed_dim)
        self.post_quant_conv = nn.Linear(cfg.embed_dim, cfg.z_channels)

    def encode(self, x):
        moments, taps = self.encoder(x)
        mean = self.quant_conv(moments)[..., : self.cfg.embed_dim]
        return self.cfg.scale_factor * mean, taps

    def decode_taps(self, latent):
        return self.decoder(self.post_quant_conv(latent / self.cfg.scale_factor))

    def decode(self, latent):
        """(rgb, taps) of the whole decoder."""
        return self.decoder(self.post_quant_conv(latent / self.cfg.scale_factor), full=True)
