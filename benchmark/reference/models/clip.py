"""CLIP ViT text and vision towers and MaskCLIP.

Counterpart of `xmask3d_tpu/models/clip.py`: pre-norm transformer with
QuickGELU, packed in-projection, the EOT-pooled text embedding, and the
single-pass masked-attention image forward that embeds all query masks at
once. Attention here is masked, so it stays plain PyTorch (matmul + softmax)
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from benchmark.reference.device import device_constant
from benchmark.reference.models.layers import Conv, LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 768


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    embed_dim: int = 768


VIT_L_14 = (CLIPTextConfig(), CLIPVisionConfig())
VIT_L_14_336 = (CLIPTextConfig(), CLIPVisionConfig(image_size=336))
VIT_TINY = (
    CLIPTextConfig(vocab_size=512, context_length=16, width=32, layers=2, heads=2, embed_dim=768),
    CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2, embed_dim=768),
)
CLIP_CONFIGS = {"ViT-L-14": VIT_L_14, "ViT-L-14-336": VIT_L_14_336, "ViT-tiny": VIT_TINY}

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)
_MASKED = torch.finfo(torch.float32).min / 2


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def heads_of(m, first: int, h: int):
    """Heads [first, first + h) of a (B, H, Tq, Tk) mask or bias; one that
    broadcasts over the heads (H = 1), or None, as it is."""
    if m is None or m.shape[1] == 1:
        return m
    return m[:, first:first + h]


class MultiHeadAttention(nn.Module):
    """MHA with a packed in-projection. `blocked` is a bool mask (True = may
    not attend) broadcastable to (B, H, Tq, Tk); `bias` is additive. The
    heads it runs are those its `in_proj` holds: all of them, or a model
    rank's under tensor parallelism (`parallel/tensor.py`: the q, k and v
    columns of heads [first_head, first_head + h)), which then take their
    slice of a mask or bias with a head axis."""

    first_head = 0

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, c // heads
        self.in_proj = nn.Linear(c, 3 * c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, blocked=None, bias=None):
        b, t = x.shape[:2]
        d = self.head_dim
        h = self.in_proj.weight.shape[0] // (3 * d)
        if h != self.heads:
            blocked = heads_of(blocked, self.first_head, h)
            bias = heads_of(bias, self.first_head, h)
        q, k, v = self.in_proj(x).reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
        scores = torch.einsum("bhqd,bhkd->bhqk", q * (d ** -0.5), k).float()
        if bias is not None:
            scores = scores + bias
        if blocked is not None:
            scores = scores.masked_fill(blocked, _MASKED)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, h * d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(c)
        self.attn = MultiHeadAttention(c, heads)
        self.ln_2 = LayerNorm(c)
        self.mlp_c_fc = nn.Linear(c, 4 * c)
        self.mlp_c_proj = nn.Linear(4 * c, c)

    def forward(self, x, blocked=None, bias=None):
        x = x + self.attn(self.ln_1(x), blocked=blocked, bias=bias)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, c: int, layers: int, heads: int):
        super().__init__()
        for i in range(layers):
            setattr(self, f"resblock_{i}", ResidualAttentionBlock(c, heads))
        self.n_layers = layers

    def forward(self, x, blocked=None, bias=None):
        for i in range(self.n_layers):
            x = getattr(self, f"resblock_{i}")(x, blocked=blocked, bias=bias)
        return x


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg
        self.token_embedding = nn.Parameter(torch.randn(c.vocab_size, c.width) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn(c.context_length, c.width) * 0.01)
        self.transformer = Transformer(c.width, c.layers, c.heads)
        self.ln_final = LayerNorm(c.width)
        self.text_projection = nn.Parameter(torch.randn(c.width, c.embed_dim) * c.width ** -0.5)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) int -> (pooled EOT embedding (B, E), encodings (B, T, W))."""
        x = self.token_embedding[tokens.long()]
        x = x + self.positional_embedding[None, : x.shape[1]]
        t = x.shape[1]
        causal = torch.triu(torch.full((t, t), _MASKED, device=x.device), diagonal=1)
        x = self.ln_final(self.transformer(x, bias=causal[None, None]))
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection, x


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        n = (c.image_size // c.patch_size) ** 2
        self.conv1 = Conv(3, c.width, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(c.width) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn(n + 1, c.width) * 0.01)
        self.ln_pre = LayerNorm(c.width)
        self.transformer = Transformer(c.width, c.layers, c.heads)
        self.ln_post = LayerNorm(c.width)
        self.proj = nn.Parameter(torch.randn(c.width, c.embed_dim) * c.width ** -0.5)

    def grid_size(self) -> int:
        return self.cfg.image_size // self.cfg.patch_size

    def forward(self, image, num_mask_tokens: int = 0, blocked=None):
        """image (B, S, S, 3) normalised NHWC -> projected tokens
        (B, num_mask_tokens + 1 + N, E); mask tokens are replicated cls
        tokens prepended before the transformer (MaskCLIP)."""
        c = self.cfg
        b = image.shape[0]
        x = self.conv1(image.to(self.proj.dtype)).reshape(b, -1, c.width)
        cls = self.class_embedding.expand(b, 1, c.width)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding[None])
        if num_mask_tokens:
            x = torch.cat([x[:, 0:1].expand(b, num_mask_tokens, c.width), x], dim=1)
        x = self.ln_post(self.transformer(x, blocked=blocked))
        return x @ self.proj


def mask_attn_blocked(mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """MaskCLIP attention mask: mask (B, Q, S, S) logits -> (B, 1, T, T) bool,
    True = may not attend. Token layout [Q mask tokens, cls, patches]; no
    token attends to mask tokens, and mask token q attends only the cls
    token and its own patches (>= 0.5 after max-pooling to the grid)."""
    b, q, s = mask.shape[0], mask.shape[1], mask.shape[2]
    p = patch_size
    g = s // p
    patch = torch.sigmoid(mask).reshape(b, q, g, p, g, p).amax(dim=(3, 5))
    blocked_patches = (patch < 0.5).reshape(b, q, g * g)
    t = q + 1 + g * g
    blocked = torch.zeros((b, t, t), dtype=torch.bool, device=mask.device)
    blocked[:, :, :q] = True
    blocked[:, :q, q + 1:] = blocked_patches
    return blocked[:, None]


class CLIP(nn.Module):
    """Joint text + vision CLIP with the MaskCLIP masked-attention forward."""

    def __init__(self, text_cfg: CLIPTextConfig, vision_cfg: CLIPVisionConfig):
        super().__init__()
        self.vision_cfg = vision_cfg
        self.text = CLIPTextTower(text_cfg)
        self.visual = CLIPVisionTower(vision_cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        dt, dev = image.dtype, image.device
        mean = device_constant(("clip_pixel_mean", dt), dev,
                               lambda: torch.tensor(CLIP_PIXEL_MEAN, dtype=dt))
        std = device_constant(("clip_pixel_std", dt), dev,
                              lambda: torch.tensor(CLIP_PIXEL_STD, dtype=dt))
        return (image - mean) / std

    def embed_text(self, tokens: torch.Tensor):
        return self.text(tokens)

    def embed_image(self, image: torch.Tensor, normalize: bool = False):
        """image (B, S, S, 3) in 0..1 at the tower's size -> (the cls
        token's embedding (B, E), the patch tokens' (B, N, E)); with
        `normalize` the embedding has unit L2 norm."""
        toks = self.visual(self.preprocess(image))
        image_embed, encodings = toks[:, 0], toks[:, 1:]
        if normalize:
            image_embed = image_embed / torch.linalg.vector_norm(image_embed, dim=-1,
                                                                 keepdim=True)
        return image_embed, encodings

    def clamped_logit_scale(self, max_scale: float = 100.0) -> torch.Tensor:
        return torch.clamp(torch.exp(self.logit_scale), max=max_scale)

    def encode_image_with_mask(self, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """image (B, S, S, 3) in 0..1, mask (B, Q, S, S) logits -> (B, Q, E)."""
        q = mask.shape[1]
        blocked = mask_attn_blocked(mask, self.vision_cfg.patch_size)
        toks = self.visual(self.preprocess(image), num_mask_tokens=q, blocked=blocked)
        return toks[:, :q]


def build_clip(name: str) -> CLIP:
    text_cfg, vision_cfg = CLIP_CONFIGS[name]
    return CLIP(text_cfg, vision_cfg)
