"""LDM feature extractor + implicit captioner conditioning.

Counterpart of `xmask3d_tpu/models/ldm_extractor.py`: one VAE-encode ->
q_sample(t = 0, shared noise) -> UNet -> VAE-decode pass, harvesting taps;
the 3D global embedding conditions the UNet through a 77-token pseudo-text
sequence `uncond + tanh(alpha) * proj(prefix)` and a time-embedding offset.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
from torch import nn

from benchmark.reference.models.clip import CLIPTextConfig, CLIPTextTower
from benchmark.reference.models.diffusion import GaussianDiffusion
from benchmark.reference.models.layers import resize
from benchmark.reference.models.sd_unet import SDUNet, UNetConfig, UNET_TINY
from benchmark.reference.models.vae import AutoencoderKL, VAEConfig, VAE_TINY


@dataclasses.dataclass(frozen=True)
class LdmConfig:
    vae: VAEConfig = VAEConfig()
    unet: UNetConfig = UNetConfig()
    text: CLIPTextConfig = CLIPTextConfig()
    encoder_block_indices: Sequence[int] = (5, 7)
    unet_block_indices: Sequence[int] = (2, 5, 8, 11)
    decoder_block_indices: Sequence[int] = (2, 5)
    steps: Sequence[int] = (0,)
    diffusion_steps: int = 1000
    noise_schedule: str = "ldm_linear"

    def vae_stride(self) -> int:
        return 2 ** (len(self.vae.ch_mult) - 1)

    def feature_strides(self) -> List[int]:
        """Image-space stride of every tap in emission order."""
        nrb = self.vae.num_res_blocks
        enc = [2 ** (idx // nrb) for idx in self.encoder_block_indices]
        vs = self.vae_stride()
        n_lv = len(self.unet.ch_mult)
        un = [vs * 2 ** (n_lv - 1 - idx // (self.unet.num_res_blocks + 1))
              for idx in self.unet_block_indices]
        dec = [vs // 2 ** (idx // (self.vae.num_res_blocks + 1))
               for idx in self.decoder_block_indices]
        return enc + un * len(self.steps) + dec

    def feature_channels(self) -> List[int]:
        """Channel width of every tap in emission order."""
        v, u = self.vae, self.unet
        enc = []
        for idx in self.encoder_block_indices:
            lv, blk = divmod(idx, v.num_res_blocks)
            if blk:
                enc.append(v.ch * v.ch_mult[lv])
            else:
                enc.append(v.ch * v.ch_mult[lv - 1] if lv else v.ch)
        # UNet taps: the [h, skip] concatenation at output block idx
        mc = u.model_channels
        skip = [mc]
        for lv, mult in enumerate(u.ch_mult):
            skip += [mc * mult] * u.num_res_blocks
            if lv != len(u.ch_mult) - 1:
                skip.append(mc * mult)
        un, ch, out_idx = [], mc * u.ch_mult[-1], 0
        for lv in reversed(range(len(u.ch_mult))):
            for _ in range(u.num_res_blocks + 1):
                s = skip.pop()
                if out_idx in self.unet_block_indices:
                    un.append(ch + s)
                ch = mc * u.ch_mult[lv]
                out_idx += 1
        dec, ch, flat = [], v.ch * v.ch_mult[-1], 0
        for lv in reversed(range(len(v.ch_mult))):
            for _ in range(v.num_res_blocks + 1):
                if flat in self.decoder_block_indices:
                    dec.append(ch)
                ch = v.ch * v.ch_mult[lv]
                flat += 1
        return enc + un * len(self.steps) + dec


LDM_SD_V1 = LdmConfig()
LDM_TINY = LdmConfig(
    vae=VAE_TINY,
    unet=UNET_TINY,
    text=CLIPTextConfig(vocab_size=512, context_length=16, width=24, layers=2, heads=2, embed_dim=24),
)


class LdmExtractor(nn.Module):
    """VAE + UNet + frozen text encoder, emitting tapped features."""

    def __init__(self, cfg: LdmConfig = LDM_SD_V1):
        super().__init__()
        self.cfg = cfg
        self.vae = AutoencoderKL(cfg.vae, cfg.encoder_block_indices, cfg.decoder_block_indices)
        self.unet = SDUNet(cfg.unet, cfg.unet_block_indices)
        self.text_encoder = CLIPTextTower(cfg.text)
        self.diffusion = GaussianDiffusion(cfg.diffusion_steps, cfg.noise_schedule)
        self.shared_noise = nn.Parameter(torch.randn(1, 64, 64, cfg.vae.embed_dim))

    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(tokens)[1]

    def forward(self, image, cond_inputs, cond_emb: Optional[torch.Tensor] = None):
        c = self.cfg
        dt = self.shared_noise.dtype
        latent, encoder_feats = self.vae.encode(((image - 0.5) / 0.5).to(dt))
        b = image.shape[0]
        unet_feats: List[torch.Tensor] = []
        for i, t in enumerate(c.steps):
            ce = cond_emb[:, i] if cond_emb is not None else None
            if t < 0:
                noisy = latent
                tb = torch.zeros((b,), dtype=torch.int64, device=image.device)
            else:
                tb = torch.full((b,), t, dtype=torch.int64, device=image.device)
                noise = self.shared_noise
                if noise.shape[1:3] != latent.shape[1:3]:
                    noise = resize(noise, latent.shape[1:3], (1, 2), "bicubic", antialias=False)
                noise = noise.expand(latent.shape).to(latent.dtype)
                noisy = self.diffusion.q_sample(latent, tb, noise)
            unet_feats.extend(self.unet(noisy, tb, cond_inputs, cond_emb=ce))
        decoder_feats = self.vae.decode_taps(latent)
        return [*encoder_feats, *unet_feats, *decoder_feats]


class PositionalLinear(nn.Module):
    """Linear + learned positional embedding broadcast over a sequence."""

    def __init__(self, in_features: int, out_features: int, seq_len: int = 77):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.randn(1, seq_len, out_features) * 0.02)
        self.linear = nn.Linear(in_features, out_features)

    def forward(self, x):
        x = self.linear(x)
        if x.ndim == 2:
            x = x[:, None, :] + self.positional_embedding.to(x.dtype)
        return x


class LdmImplicitCaptionerExtractor(nn.Module):
    """Conditions the SD UNet on the 3D global embedding."""

    def __init__(self, cfg: LdmConfig = LDM_SD_V1, dim_latent: int = 768, num_timesteps: int = 1):
        super().__init__()
        self.ldm_extractor = LdmExtractor(cfg)
        self.clip_project = PositionalLinear(dim_latent, cfg.text.width, cfg.text.context_length)
        self.alpha_cond = nn.Parameter(torch.zeros(1, cfg.text.context_length, cfg.text.width))
        time_dim = 4 * cfg.unet.model_channels
        self.time_embed_project = PositionalLinear(dim_latent, time_dim, num_timesteps)
        self.alpha_cond_time_embed = nn.Parameter(torch.zeros(time_dim))

    def condition(self, prefix, uncond):
        prefix_embed = self.clip_project(prefix)
        cond_inputs = uncond + torch.tanh(self.alpha_cond).to(prefix_embed.dtype) * prefix_embed
        cond_emb = torch.tanh(self.alpha_cond_time_embed).to(prefix.dtype) \
            * self.time_embed_project(prefix)
        return cond_inputs, cond_emb

    def forward(self, image, prefix, uncond_tokens):
        uncond = self.ldm_extractor.embed_text(uncond_tokens)
        cond_inputs, cond_emb = self.condition(prefix, uncond)
        return self.ldm_extractor(image, cond_inputs, cond_emb=cond_emb)
