"""Model + statics construction, for serving and for training.

Counterpart of `xmask3d_tpu/engine/builder.py`, with the parameter groups
of `xmask3d_tpu/engine/train_step.py` (`param_label`, `label_tree`).
`statics` are frozen constants fed to every forward:
  text_embed_train: (L_train, 768) CLIP text bank of the train label names
  text_embed_test:  (L_test, 768) bank of all label names
  uncond_tokens:    (1, T) tokenized ""
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from xmask3d_tpu_torch.config import Config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.tokenizer import build_tokenizer
from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.models.clip import CLIP_CONFIGS
from xmask3d_tpu_torch.models.layers import GroupNorm
from xmask3d_tpu_torch.models.ldm_extractor import LDM_SD_V1, LDM_TINY
from xmask3d_tpu_torch.models.xmask3d import XMask3D, XMask3DConfig


def model_config_from_cfg(cfg: Config, tiny: bool = False, fused_gn: bool = False
                          ) -> XMask3DConfig:
    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else torch.float32
    return XMask3DConfig(
        num_classes=cfg.classes,
        num_test_classes=cfg.test_classes,
        num_queries=cfg.num_queries,
        arch_3d=cfg.arch_3d,
        arch_binary_head=cfg.arch_binary_head,
        mask_shape=tuple(cfg.mask_shape),
        clip_name="ViT-tiny" if tiny else cfg.get("clip_name", "ViT-L-14"),
        ldm=LDM_TINY if tiny else LDM_SD_V1,
        base_category=tuple(cfg.category_split.base_category),
        novel_category=tuple(cfg.category_split.novel_category),
        ignore_category=tuple(cfg.category_split.ignore_category),
        ignore_label=cfg.ignore_label,
        data_ratio=cfg.data_ratio,
        binary_2d_thresh=cfg.binary_2d_thresh,
        scores_keep_thresh=cfg.scores_keep_thresh,
        caption_contra=cfg.caption_contra,
        caption_contra_2d_pre=cfg.caption_contra_2d_pre,
        caption_contra_3d=cfg.caption_contra_3d,
        mask_contra_3d=cfg.mask_contra_3d,
        dec_layers=cfg.get("dec_layers", 9),
        pixel_enc_layers=cfg.get("pixel_enc_layers", 6),
        dtype=dtype,
        fused_gn=fused_gn,
        remat_backbone=bool(cfg.get("remat_backbone", False)),
    )


def data_tokenizer(cfg: Config, tiny: bool = False):
    """Caption tokenizer matching the model's text towers: vocab size and
    context length of the CLIP config the model uses (the tiny towers run
    context 16 / vocab 512)."""
    name = "ViT-tiny" if tiny else cfg.get("clip_name", "ViT-L-14")
    text_cfg = CLIP_CONFIGS[name][0]
    return build_tokenizer(cfg.get("clip_bpe_vocab", ""), vocab_size=text_cfg.vocab_size,
                           context_length=text_cfg.context_length)


def capacities_from_cfg(cfg: Config) -> Capacities:
    return Capacities(
        max_points=cfg.get("max_points", 65536),
        max_voxels=cfg.get("max_voxels", 49152),
        max_targets=cfg.get("max_targets", 24),
    )


def _fan_in(p: torch.Tensor) -> int:
    """Contraction size of a weight: Linear (out, in), conv OIHW, sparse
    kernel (K, C_in, C_out)."""
    if p.ndim == 2:
        return p.shape[1]
    if p.ndim == 4:
        return p.shape[1] * p.shape[2] * p.shape[3]
    return p.shape[0] * p.shape[1]


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded draw of every parameter on the parameters' own device (a
    `torch.Generator` there, so a full-width model never passes through
    host memory). Norm scales are 1 and biases 0; dense weights are
    N(0, 1/fan_in) and sparse kernels N(0, 2/fan_in); the sampling-offset
    biases keep their directional grid; everything else (embeddings,
    queries, the conditioning gates) is N(0, 0.02), and the shared noise
    N(0, 1)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.ndim == 0:
                continue  # logit scales keep their constant init
            if name == "scale" or (name == "weight" and isinstance(mod, (nn.LayerNorm, GroupNorm))):
                p.fill_(1.0)
            elif name == "bias":
                if not mod_name.endswith("sampling_offsets"):
                    p.zero_()
            elif name == "shared_noise":
                p.normal_(0.0, 1.0, generator=gen)
            elif name == "weight":
                p.normal_(0.0, 1.0 / math.sqrt(_fan_in(p)), generator=gen)
            elif name == "kernel":  # sparse (K, C_in, C_out): He init, for the ReLU nets
                p.normal_(0.0, math.sqrt(2.0 / _fan_in(p)), generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    for mod in model.modules():
        for name, buf in mod.named_buffers(recurse=False):
            if name == "mean":
                buf.zero_()
            elif name == "var":
                buf.fill_(1.0)


def build_model(cfg: Config, tiny: bool = False, seed: int = 0, device=None,
                fused_gn: bool = False) -> XMask3D:
    """The eval-mode model on `device` (the GPU unless "cpu" is asked for),
    weights drawn from `seed`. Parameters are stored in the config's
    `compute_dtype`; the BatchNorm running statistics stay fp32, as in the
    JAX package's serving cast. `fused_gn` runs the VAE resblocks'
    GroupNorm -> SiLU -> conv3x3 stages on kernel K4 (same parameters)."""
    dev = resolve_device(device)
    mc = model_config_from_cfg(cfg, tiny=tiny, fused_gn=fused_gn)
    with torch.device(dev):
        model = XMask3D(mc)
    init_weights(model, seed)
    model.eval().requires_grad_(False)
    for p in model.parameters():
        p.data = p.data.to(mc.dtype)
    return model


# parameters that training leaves as they are: the SD towers and CLIP
FROZEN_MARKERS = ("ldm_extractor/vae", "ldm_extractor/unet", "ldm_extractor/text_encoder",
                  "ldm_extractor/shared_noise", "clip/")


def param_label(path_keys) -> str:
    """Optimizer group of a parameter from its path: "3d" (the 3D UNets),
    "frozen" (SD VAE, UNet and text encoder, the shared noise, CLIP) or
    "others". The JAX package's rule over the same path components."""
    name = "/".join(str(k) for k in path_keys)
    if "pc_decoder" in name or "pc_binary_head" in name:
        return "3d"
    if any(m in name for m in FROZEN_MARKERS) or name.startswith("clip"):
        return "frozen"
    return "others"


def label_tree(model: nn.Module) -> Dict[str, str]:
    """{dotted parameter name: group} for every parameter of the model."""
    return {name: param_label(name.split(".")) for name, _ in model.named_parameters()}


def build_train_model(cfg: Config, tiny: bool = False, seed: int = 0, device=None,
                      fused_gn: bool = False) -> XMask3D:
    """`build_model` set up for training: in train mode (which switches only
    the BatchNorms to batch statistics) with the frozen group's parameters
    excluded from autograd, so no gradient is computed for them while
    gradients still flow through their activations (the JAX package's
    `stop_gradient` on frozen leaves). Parameters stay in the compute dtype;
    the optimizer keeps fp32 masters of the trainable ones
    (`engine/train_step.py`)."""
    model = build_model(cfg, tiny=tiny, seed=seed, device=device, fused_gn=fused_gn)
    labels = label_tree(model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    return model.train()


def build_statics(model: XMask3D, cfg: Config, tokenizer=None, device=None
                  ) -> Dict[str, torch.Tensor]:
    """The frozen CLIP text banks + uncond tokens, through the model's CLIP
    text tower on `device` (the GPU unless "cpu" is asked for)."""
    dev = resolve_device(device)
    text_cfg = CLIP_CONFIGS[model.cfg.clip_name][0]
    if tokenizer is None:
        tokenizer = build_tokenizer(
            cfg.get("clip_bpe_vocab", ""), vocab_size=text_cfg.vocab_size,
            context_length=text_cfg.context_length,
        )

    def embed(texts: List[str]) -> torch.Tensor:
        toks = torch.from_numpy(tokenizer(texts)).to(dev)
        with torch.no_grad():
            return model.embed_captions(toks)

    return {
        "text_embed_train": embed(list(cfg.label)),
        "text_embed_test": embed(list(cfg.all_label)),
        "uncond_tokens": torch.from_numpy(tokenizer([""])).to(dev),
    }
