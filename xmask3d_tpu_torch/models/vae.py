"""Stable Diffusion v1 VAE (AutoencoderKL), NHWC, with feature taps.

Counterpart of `xmask3d_tpu/models/vae.py`: GroupNorm -> SiLU -> conv
resblocks, each stage either as three modules (the default) or, with
`fused_gn`, as one call of kernel K4 (`ops/gn_conv.py`) on the same
parameters; single-head mid-block attention through kernel K2. The encoder
and decoder return the inputs of the flattened blocks listed in their tap
indices. `decode_taps` stops the decoder once its last tap is taken, since
the eval path uses only the taps (the rest of the decoder is dead code that
XLA removes on the JAX side); `decode` runs every level and the output head
and returns (rgb, taps), the sampler's path.

Under `activation_sharding` (`parallel/spatial.py`) the encoder and the
decoder each run in row bands over the mesh's model group where their
input's rows allow: the JAX module's `shard_spatial` on every block output.
The mid attention gathers its keys and values and runs K2 on the band's
queries; with `fused_gn`, K4 takes the bands' merged statistics and the
neighbours' raw edge rows (`ResnetBlock._stage`). The taps, the moments and
the RGB are gathered at the exit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xmask3d_tpu_torch.models.layers import Conv, GroupNorm, RematBlock, upsample2x_nearest
from xmask3d_tpu_torch.ops.flash_attention import attention
from xmask3d_tpu_torch.ops.gn_conv import (
    affine_from_moments, affine_silu_conv, gn_silu_conv, group_moments, kernel_params)
from xmask3d_tpu_torch.parallel import spatial


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
    """Two GroupNorm -> SiLU -> conv3x3 stages and a residual. The parameter
    tree is the same with `fused_gn` on or off."""

    def __init__(self, in_ch: int, out_ch: int, fused_gn: bool = False):
        super().__init__()
        self.fused_gn = fused_gn
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv(in_ch, out_ch, 1)
        self._k4_params = {}  # conv name -> (key, K4's layout of its weight and bias)

    def _stage(self, x, norm: GroupNorm, conv: Conv, name: str):
        """GroupNorm -> SiLU -> conv3x3. With `fused_gn` one K4 call; in a
        band, K4's statistics of the band (`group_moments`) merged over the
        ranks in rank order (`affine_from_moments`), then its conv on the
        band with one raw row of each neighbour (`affine_silu_conv`), whose
        outputs on those rows are dropped."""
        if not self.fused_gn:
            return conv(norm(x, silu=True))
        # the port's Conv stores OIHW; K4 takes HWIO, and on the card its own
        # layout, made again only when the weights or x's type change
        w = conv.weight.permute(2, 3, 1, 0)
        params = None
        if x.is_cuda:
            key = (w.data_ptr(), w._version, conv.bias.data_ptr(), conv.bias._version, x.dtype)
            hit = self._k4_params.get(name)
            if hit is None or hit[0] != key:
                hit = self._k4_params[name] = (key, kernel_params(w, conv.bias, x.dtype))
            params = hit[1]
        x = x.contiguous()
        if spatial.current_band() is None:
            return gn_silu_conv(x, norm.weight, norm.bias, w, conv.bias, groups=norm.groups,
                                params=params)
        moments = spatial.gather_rows(group_moments(x, norm.groups)[None], dim=0)
        a, s = affine_from_moments(moments, norm.weight, norm.bias)
        ext, top, bottom = spatial.raw_halo(x, 1)
        y = affine_silu_conv(ext, a, s, w, conv.bias, params=params)
        return y[:, top:y.shape[1] - bottom]

    def body(self, x):
        h = self._stage(x, self.norm1, self.conv1, "conv1")
        h = self._stage(h, self.norm2, self.conv2, "conv2")
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(RematBlock):
    """Single-head spatial self-attention over H x W (VAE mid block); in a
    band, the band's queries against every band's keys and values."""

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
        k, v = spatial.gather_rows(k, dim=2), spatial.gather_rows(v, dim=2)
        out = attention(q, k, v).reshape(b, h, w, c)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2)

    def forward(self, x):
        # SD's asymmetric (0, 1) padding for the strided conv; in a band the
        # row below comes from the next band (the last one's is the pad row)
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, int(spatial.current_band() is None))))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample2x_nearest(x))


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, tap_indices: Sequence[int] = (5, 7),
                 fused_gn: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.tap_indices = cfg, tuple(tap_indices)
        self.conv_in = Conv(3, c.ch, 3, padding=1)
        ch = c.ch
        for i_level, mult in enumerate(c.ch_mult):
            for i_block in range(c.num_res_blocks):
                setattr(self, f"down_{i_level}_block_{i_block}", ResnetBlock(ch, c.ch * mult, fused_gn))
                ch = c.ch * mult
            if i_level != len(c.ch_mult) - 1:
                setattr(self, f"down_{i_level}_downsample", Downsample(ch))
        self.mid_block_1 = ResnetBlock(ch, ch, fused_gn)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch, fused_gn)
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, 2 * c.z_channels, 3, padding=1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        with spatial.banded(x.shape[1], len(self.cfg.ch_mult) - 1) as band:
            out = self._forward(x)
            return out if band is None else spatial.gather_outputs(out)

    def _forward(self, x):
        c = self.cfg
        taps, flat_idx = [], 0
        h = self.conv_in(x, replicated=True)
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
    def __init__(self, cfg: VAEConfig, tap_indices: Sequence[int] = (2, 5),
                 fused_gn: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.tap_indices = cfg, tuple(tap_indices)
        n_lv = len(c.ch_mult)
        block_in = c.ch * c.ch_mult[-1]
        self.conv_in = Conv(c.z_channels, block_in, 3, padding=1)
        self.mid_block_1 = ResnetBlock(block_in, block_in, fused_gn)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in, fused_gn)
        ch = block_in
        for i_level in reversed(range(n_lv)):
            out_ch = c.ch * c.ch_mult[i_level]
            for i_block in range(c.num_res_blocks + 1):
                setattr(self, f"up_{i_level}_block_{i_block}", ResnetBlock(ch, out_ch, fused_gn))
                ch = out_ch
            if i_level != 0:
                setattr(self, f"up_{i_level}_upsample", Upsample(ch))
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, 3, 3, padding=1)

    def forward(self, z, full: bool = False):
        """The decoder taps, stopping once the last one is taken; with
        `full`, (rgb (B, H, W, 3), taps) after every level, `norm_out`
        (plain GroupNorm), SiLU and `conv_out`."""
        with spatial.banded(z.shape[1]) as band:
            out = self._forward(z, full)
            return out if band is None else spatial.gather_outputs(out)

    def _forward(self, z, full):
        c = self.cfg
        taps, flat_idx = [], 0
        last = max(self.tap_indices)
        h = self.conv_in(z, replicated=True)
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
        return self.conv_out(self.norm_out(h, silu=True)), taps


class AutoencoderKL(nn.Module):
    """VAE with quant/post-quant 1x1 projections and mean latents."""

    def __init__(self, cfg: VAEConfig, encoder_taps=(5, 7), decoder_taps=(2, 5),
                 fused_gn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg, encoder_taps, fused_gn)
        self.decoder = VAEDecoder(cfg, decoder_taps, fused_gn)
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
