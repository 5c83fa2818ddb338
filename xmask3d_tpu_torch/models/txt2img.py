"""Text-to-image sampling with classifier-free guidance.

Counterpart of `xmask3d_tpu/models/txt2img.py`: DDIM over SD latents with
the conditional and unconditional passes batched into one UNet call, then
the VAE decoder. Not used by the segmentation path.
"""

from __future__ import annotations

from typing import Optional

import torch

from xmask3d_tpu_torch.models.diffusion import GaussianDiffusion, Noise
from xmask3d_tpu_torch.models.sd_unet import SDUNet
from xmask3d_tpu_torch.models.vae import AutoencoderKL


@torch.no_grad()
def sample_images(unet: SDUNet, vae: AutoencoderKL, diffusion: GaussianDiffusion,
                  cond: torch.Tensor, uncond: torch.Tensor,
                  generator: Optional[torch.Generator] = None, latent_hw=(64, 64),
                  latent_dim: int = 4, guidance_scale: float = 7.5, pixel_mean: float = 0.5,
                  pixel_std: float = 0.5, noise: Optional[Noise] = None) -> torch.Tensor:
    """DDIM sampling with CFG from (B, 77, ctx) text and empty-prompt
    contexts on the models' device; the latents' noise comes from
    `generator` (on that device) or `noise` (`ddim_sample_loop`). Returns
    images (B, H, W, 3) in [0, 1], fp32."""
    b = cond.shape[0]
    dt = unet.time_embed_0.weight.dtype

    if guidance_scale != 1.0:
        ctx = torch.cat([cond, uncond], dim=0).to(dt)

        def model(x, t):
            eps, _ = unet(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), ctx, full=True)
            eps_c, eps_u = eps.float().chunk(2, dim=0)
            return eps_u + guidance_scale * (eps_c - eps_u)
    else:
        ctx = cond.to(dt)

        def model(x, t):
            return unet(x, t, ctx, full=True)[0]

    latents = diffusion.ddim_sample_loop(
        model, (b, latent_hw[0], latent_hw[1], latent_dim), generator, clip_denoised=False,
        device=cond.device, noise=noise)
    rgb, _ = vae.decode(latents.to(dt))
    return torch.clamp(rgb.float() * pixel_std + pixel_mean, 0.0, 1.0)
