"""ODISE-style masked transformer decoder + mask-embed heads.

Counterpart of `xmask3d_tpu/models/mask_decoder.py` (eval path): rounds of
[masked cross-attention over one pyramid level, self-attention, FFN] on the
learned queries, with per-layer prediction heads whose masks gate the next
layer's cross-attention. The attention is masked, so it stays plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import LayerNorm, resize
from benchmark.reference.models.pixel_decoder import sine_embedding

_MASKED = torch.finfo(torch.float32).min / 2


class MHA(nn.Module):
    """Multi-head attention with separate q/k/v sources and an optional
    bool `blocked` mask (True = no attention)."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, q_in, k_in, v_in, blocked=None):
        c, h = q_in.shape[-1], self.heads

        def split(z):
            return z.reshape(z.shape[0], z.shape[1], h, c // h).transpose(1, 2)

        q, k, v = split(self.q_proj(q_in)), split(self.k_proj(k_in)), split(self.v_proj(v_in))
        scores = torch.einsum("bhqd,bhkd->bhqk", q * ((c // h) ** -0.5), k).float()
        if blocked is not None:
            scores = scores.masked_fill(blocked, _MASKED)
        attn = torch.softmax(scores, dim=-1).to(q_in.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], c))


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            d_in = in_dim if i == 0 else hidden_dim
            d_out = output_dim if i == num_layers - 1 else hidden_dim
            setattr(self, f"layer_{i}", nn.Linear(d_in, d_out))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer_{i}")(x))
        return getattr(self, f"layer_{self.num_layers - 1}")(x)


def pseudo_class_embed(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Constant fg/bg logits; real class logits come from the CLIP space."""
    fg = torch.ones(x.shape[:-1] + (num_classes,), dtype=x.dtype, device=x.device)
    bg = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([fg, bg], dim=-1)


def mask_pooling(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Average x (B, H, W, C) under each hard (sigmoid > 0.5) mask of
    (B, Q, H, W) logits; fp32 count and accumulation."""
    m = (torch.sigmoid(mask) > 0.5).to(x.dtype)
    denom = m.float().sum(dim=(-1, -2))[..., None] + 1e-8
    pooled = torch.einsum("bhwc,bqhw->bqc", x.float(), m.float())
    return (pooled / denom).to(x.dtype)


class PooledMaskEmbed(nn.Module):
    """Mask-pooled CLIP-space embedding head."""

    def __init__(self, hidden_dim: int = 256, mask_dim: int = 256,
                 projection_dim: int = 768, temperature: float = 0.07):
        super().__init__()
        self.pool_norm = LayerNorm(mask_dim)
        self.pool_proj = nn.Linear(mask_dim, hidden_dim)
        self.embed_norm = LayerNorm(hidden_dim)
        self.embed_mlp = MLP(hidden_dim, hidden_dim, projection_dim, 3)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / temperature)))

    def forward(self, decoder_output, mask_features, pred_masks):
        pooled = self.pool_proj(self.pool_norm(mask_pooling(mask_features, pred_masks)))
        pooled = pooled + decoder_output
        return {
            "mask_embed": self.embed_mlp(self.embed_norm(pooled)),
            "mask_pooled_features": pooled,
            "logit_scale": torch.clamp(torch.exp(self.logit_scale.float()), max=100.0),
        }


class DecoderLayer(nn.Module):
    """masked cross-attn -> self-attn -> FFN (post-norm)."""

    def __init__(self, c: int = 256, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.cross_attn = MHA(c, heads)
        self.norm1 = LayerNorm(c)
        self.self_attn = MHA(c, heads)
        self.norm2 = LayerNorm(c)
        self.ffn1 = nn.Linear(c, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, c)
        self.norm3 = LayerNorm(c)

    def forward(self, output, query_embed, src, pos, blocked):
        output = self.norm1(output + self.cross_attn(output + query_embed, src + pos, src, blocked))
        q = output + query_embed
        output = self.norm2(output + self.self_attn(q, q, output))
        return self.norm3(output + self.ffn2(F.relu(self.ffn1(output))))


class ODISEMaskedTransformerDecoder(nn.Module):
    """forward([s32, s16, s8] maps, mask_features (B, H4, W4, C)) -> dict
    with pred_logits / pred_masks / mask_embed / logit_scale / aux_outputs."""

    def __init__(self, num_classes: int = 15, hidden_dim: int = 256, num_queries: int = 50,
                 heads: int = 8, ffn_dim: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 256, projection_dim: int = 768):
        super().__init__()
        self.num_classes, self.num_queries = num_classes, num_queries
        self.hidden_dim, self.dec_layers = hidden_dim, dec_layers
        self.query_feat = nn.Parameter(torch.randn(num_queries, hidden_dim))
        self.query_embed = nn.Parameter(torch.randn(num_queries, hidden_dim))
        self.level_embed = nn.Parameter(torch.randn(3, hidden_dim))
        for i in range(dec_layers):
            setattr(self, f"layer_{i}", DecoderLayer(hidden_dim, heads, ffn_dim))
        self.decoder_norm = LayerNorm(hidden_dim)
        self.mask_embed_mlp = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        self.post_mask_embed = PooledMaskEmbed(hidden_dim, mask_dim, projection_dim)

    def _prediction_heads(self, output, mask_features, target_hw):
        x = self.decoder_norm(output)
        outputs_class = pseudo_class_embed(x, self.num_classes)
        mask_embed_in = self.mask_embed_mlp(x)
        outputs_mask = torch.einsum(
            "bqc,bhwc->bqhw", mask_embed_in.float(), mask_features.float()
        ).to(mask_features.dtype)
        extras = self.post_mask_embed(x, mask_features, outputs_mask)
        b, q = outputs_mask.shape[:2]
        am = resize(outputs_mask, target_hw, (2, 3), "bilinear", antialias=False)
        blocked = torch.sigmoid(am.reshape(b, q, -1)) < 0.5
        # un-block rows that would otherwise attend to nothing
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        return outputs_class, outputs_mask, blocked[:, None], extras

    def forward(self, multi_scale_features: List[torch.Tensor], mask_features) -> Dict[str, Any]:
        if len(multi_scale_features) != 3:
            raise ValueError("expected 3 pyramid levels")
        srcs, poss, sizes = [], [], []
        for i, f in enumerate(multi_scale_features):
            b, hh, ww, c = f.shape
            pos = sine_embedding(hh, ww, self.hidden_dim // 2, f.device)
            poss.append(pos.to(f.dtype).reshape(1, hh * ww, c))
            srcs.append(f.reshape(b, hh * ww, c) + self.level_embed[i])
            sizes.append((hh, ww))
        b = multi_scale_features[0].shape[0]
        output = self.query_feat[None].expand(b, -1, -1)
        query_embed = self.query_embed[None]
        classes, masks, extras_list = [], [], []
        oc, om, blocked, extras = self._prediction_heads(output, mask_features, sizes[0])
        classes.append(oc)
        masks.append(om)
        extras_list.append(extras)
        for i in range(self.dec_layers):
            li = i % 3
            output = getattr(self, f"layer_{i}")(output, query_embed, srcs[li], poss[li], blocked)
            oc, om, blocked, extras = self._prediction_heads(
                output, mask_features, sizes[(i + 1) % 3])
            classes.append(oc)
            masks.append(om)
            extras_list.append(extras)
        return {
            "pred_logits": classes[-1],
            "pred_masks": masks[-1],
            **extras_list[-1],
            "aux_outputs": [
                {"pred_logits": c, "pred_masks": m, **e}
                for c, m, e in zip(classes[:-1], masks[:-1], extras_list[:-1])
            ],
        }


class CategoryEmbed(nn.Module):
    """Learnable null embedding; the CLIP text banks come in precomputed.
    The projection is the identity in every shipped config."""

    def __init__(self, embed_dim: int = 768):
        super().__init__()
        self.null_embed = nn.Parameter(torch.randn(1, embed_dim) * 0.02)

    def forward(self, text_embed: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"text_embed": text_embed, "null_embed": self.null_embed}
