"""The reference model of a configuration file, built from the file's
numbers alone, and its weights."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.weights import make_weights, specs
from benchmark.reference.models.ldm_extractor import LDM_SD_V1, LDM_TINY
from benchmark.reference.models.xmask3d import XMask3D, XMask3DConfig


def model_config(conf: Dict, dtype=torch.float32, tiny: bool = False) -> XMask3DConfig:
    return XMask3DConfig(
        num_classes=conf["classes"], num_test_classes=conf["test_classes"],
        num_queries=conf["num_queries"], arch_3d=conf["arch_3d"],
        arch_binary_head=conf["arch_binary_head"], mask_shape=tuple(conf["mask_shape"]),
        clip_name="ViT-tiny" if tiny else conf["clip_name"],
        ldm=LDM_TINY if tiny else LDM_SD_V1,
        base_category=tuple(conf["base_category"]), novel_category=tuple(conf["novel_category"]),
        ignore_category=tuple(conf["ignore_category"]), ignore_label=conf["ignore_label"],
        data_ratio=conf["data_ratio"], binary_2d_thresh=conf["binary_2d_thresh"],
        scores_keep_thresh=conf["scores_keep_thresh"], dec_layers=conf["dec_layers"],
        pixel_enc_layers=conf["pixel_enc_layers"], dtype=dtype,
        remat_backbone=conf["remat_backbone"])


def skeleton(conf: Dict, tiny: bool, device) -> XMask3D:
    """The module tree, for its names, shapes and module types. On the card
    it is built in about a second and then dropped; on the meta device its
    constructors' random fills would import the compiler stack (seconds of
    set-up)."""
    with torch.device(device):
        return XMask3D(model_config(conf, tiny=tiny))


def leaf_specs(conf: Dict, tiny: bool, device):
    """`weights.specs` of the configuration's model tree, built on
    `device` (the card in runs) and dropped."""
    model = skeleton(conf, tiny=tiny, device=device)
    out = specs(model)
    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def build_reference(conf: Dict, seed: int, device, dtype=torch.float32, tiny: bool = False,
                    weights=None) -> XMask3D:
    """The eval-mode reference computing in `dtype`, with the seed's weights
    (the bf16 draw, widened for fp32); its parameters are stored in `dtype`
    and the BatchNorm statistics in fp32."""
    if weights is None:
        weights = make_weights(leaf_specs(conf, tiny, device), seed, device)
    with torch.device(device):
        model = XMask3D(model_config(conf, dtype=dtype, tiny=tiny))
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            src = weights[name]
            t.copy_(src if name.endswith((".mean", ".var")) else src.to(dtype))
    del weights
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model.eval().requires_grad_(False)
