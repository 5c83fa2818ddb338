"""Multi-scale projection backbone over the LDM feature taps.

Counterpart of `xmask3d_tpu/models/backbone.py`: per-tap bottleneck
projection to 512 channels, strides clamped to [4, 32], grouped into
s2..s5 with a nearest-resize restore and a per-group sum.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xmask3d_tpu_torch.models.layers import Conv, GroupNorm, upsample_nearest_int
from xmask3d_tpu_torch.models.ldm_extractor import LdmConfig, LdmImplicitCaptionerExtractor


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual projection with GroupNorm."""

    def __init__(self, in_ch: int, out_ch: int, bottleneck: int):
        super().__init__()
        self.conv1 = Conv(in_ch, bottleneck, 1, bias=False)
        self.norm1 = GroupNorm(bottleneck)
        self.conv2 = Conv(bottleneck, bottleneck, 3, padding=1, bias=False)
        self.norm2 = GroupNorm(bottleneck)
        self.conv3 = Conv(bottleneck, out_ch, 1, bias=False)
        self.norm3 = GroupNorm(out_ch)
        if in_ch != out_ch:
            self.shortcut = Conv(in_ch, out_ch, 1, bias=False)
            self.shortcut_norm = GroupNorm(out_ch)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        sc = self.shortcut_norm(self.shortcut(x)) if hasattr(self, "shortcut") else x
        return F.relu(y + sc)


class FeatureExtractorBackbone(nn.Module):
    """The implicit-captioner LDM extractor as a multi-scale backbone
    emitting {"s2": stride 4, ..., "s5": stride 32}."""

    def __init__(self, ldm_cfg: LdmConfig, out_features: Sequence[str] = ("s2", "s3", "s4", "s5"),
                 min_stride: int = 4, max_stride: int = 32, projection_dim: int = 512,
                 fused_gn: bool = False):
        super().__init__()
        self.ldm_cfg, self.out_features = ldm_cfg, tuple(out_features)
        self.min_stride, self.max_stride = min_stride, max_stride
        self.feature_extractor = LdmImplicitCaptionerExtractor(ldm_cfg, fused_gn=fused_gn)
        for i, ch in enumerate(ldm_cfg.feature_channels()):
            setattr(self, f"proj_{i}", BottleneckBlock(ch, projection_dim, projection_dim // 4))

    def _grouping(self) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = defaultdict(list)
        for idx, s in enumerate(self.ldm_cfg.feature_strides()):
            groups[min(max(s, self.min_stride), self.max_stride)].append(idx)
        return {s: groups[s] for s in sorted(groups)}

    def forward(self, image, prefix, uncond_tokens) -> Dict[str, torch.Tensor]:
        h, w = image.shape[1], image.shape[2]
        taps = self.feature_extractor(image, prefix, uncond_tokens)
        out: Dict[str, torch.Tensor] = {}
        for stride, indices in self._grouping().items():
            name = f"s{int(math.log2(stride))}"
            if name not in self.out_features:
                continue
            acc = None
            for idx in indices:
                f = taps[idx]
                th, tw = h // stride, w // stride
                if f.shape[1:3] != (th, tw):
                    sh, rh = divmod(th, f.shape[1])
                    sw, rw = divmod(tw, f.shape[2])
                    if rh or rw or sh < 1 or sw < 1:
                        raise ValueError(f"tap {idx} of shape {tuple(f.shape)} does not "
                                         f"upsample by an integer factor to {(th, tw)}")
                    f = upsample_nearest_int(f, sh, sw)
                p = getattr(self, f"proj_{idx}")(f)
                acc = p if acc is None else acc + p
            out[name] = acc
        return out

    def slide_forward(self, image, prefix, uncond_tokens, crop: int = 512
                      ) -> Dict[str, torch.Tensor]:
        """Sliding-window forward for images larger than the training crop
        (reference feature_extractor.py:169-226): each crop x crop window
        goes through `forward` and its maps are placed into full-size ones.
        The window grid does not overlap (stride = crop), so H and W must
        be multiples of crop, as in the JAX package."""
        b, h, w, _ = image.shape
        if h % crop or w % crop:
            raise ValueError(f"image {h}x{w} is not a multiple of the crop {crop}: pad it")
        outs: Dict[str, torch.Tensor] = {}
        for yi in range(h // crop):
            for xi in range(w // crop):
                window = image[:, yi * crop:(yi + 1) * crop, xi * crop:(xi + 1) * crop]
                for k, v in self(window, prefix, uncond_tokens).items():
                    s = crop // v.shape[1]
                    if k not in outs:
                        outs[k] = v.new_zeros((b, h // s, w // s, v.shape[-1]))
                    outs[k][:, yi * crop // s:(yi + 1) * crop // s,
                            xi * crop // s:(xi + 1) * crop // s] = v
        return outs
