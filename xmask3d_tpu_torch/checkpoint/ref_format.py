"""A port model's weights written in the released files' layouts: test
support, imported by no user path.

The inverse of the converters' names and layouts (`convert_torch.py`,
`convert_xmask3d.py`), written out on its own rather than derived from
them, so that a converter's round trip tests it. The port's counterpart of
`tests/ref_state_dict.py` and of the inverse helpers in
`tests/test_converters*.py`:

- `sd_state_dict`: an SD v1 CompVis checkpoint's `state_dict`
  (`first_stage_model.*`, `model.diffusion_model.*`,
  `cond_stage_model.transformer.text_model.*`);
- `open_clip_state_dict`: an open_clip ViT state dict;
- `xmask3d_state_dict`: the released trainables (b15n4.pth.tar's
  `state_dict`, before DDP's `module.` prefix), with ME's nested
  `<name>.bn.*` BatchNorms, their `num_batches_tracked`, and the loss
  buffers the converter skips; `released_checkpoint` wraps it as
  `{epoch, state_dict, optimizer, best_iou}` with the prefix.

Each reads the module's weights in the JAX package's flat layout
(`flat_weights`) and gives fp32 torch tensors; `write_released` saves all
three files of an XMask3D model.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from xmask3d_tpu_torch.checkpoint.from_jax import bridge_tensors
from xmask3d_tpu_torch.models.layers import Conv

LDM = "backbone/feature_extractor/ldm_extractor"


def flat_weights(model: nn.Module, keep: Optional[Callable[[str], bool]] = None
                 ) -> Dict[str, Dict[str, np.ndarray]]:
    """{"params": {jax path: array}, "batch_stats": {...}} in flax layout
    (Linear (in, out), conv HWIO), fp32, for the paths `keep` accepts."""
    out: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for col, path, mod, name, t, _ in bridge_tensors(model):
        if keep is not None and not keep(path):
            continue
        a = t.detach().to("cpu", torch.float32 if t.is_floating_point() else t.dtype).numpy()
        if name == "weight" and isinstance(mod, nn.Linear):
            a = a.T
        elif name == "weight" and isinstance(mod, Conv):
            a = a.transpose(2, 3, 1, 0)
        out[col][path] = a
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _kind(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias", "scale": "weight"}[leaf]


def _dense_or_conv(a: np.ndarray) -> np.ndarray:
    """A flax kernel in torch's layout: conv HWIO -> OIHW, Dense (in, out) ->
    (out, in)."""
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


# --------------------------------------------------------------------------- #
# SD v1 (CompVis layout)
# --------------------------------------------------------------------------- #


def _vae_key(parts) -> str:
    p = "first_stage_model"
    kind = _kind(parts[-1])
    if parts[0] in ("quant_conv", "post_quant_conv"):
        return f"{p}.{parts[0]}.{kind}"
    enc, mid = parts[0], parts[1]
    if mid in ("conv_in", "conv_out", "norm_out"):
        return f"{p}.{enc}.{mid}.{kind}"
    if mid == "mid_attn_1":
        return f"{p}.{enc}.mid.attn_1.{parts[2]}.{kind}"
    if mid in ("mid_block_1", "mid_block_2"):
        return f"{p}.{enc}.mid.{mid[4:]}.{parts[2]}.{kind}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", mid)
    if m:
        return f"{p}.{enc}.{m[1]}.{m[2]}.{m[3]}.conv.{kind}"
    m = re.fullmatch(r"(down|up)_(\d+)_block_(\d+)", mid)
    return f"{p}.{enc}.{m[1]}.{m[2]}.block.{m[3]}.{parts[2]}.{kind}"


_UNET_RES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb_proj": "emb_layers.1",
             "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip": "skip_connection"}


def _unet_attn(rest) -> str:
    if rest[0] in ("norm", "proj_in", "proj_out"):
        return rest[0]
    sub = rest[1]  # rest[0] is block_0
    if sub in ("attn1", "attn2"):
        return f"transformer_blocks.0.{sub}." + ("to_out.0" if rest[2] == "to_out" else rest[2])
    if sub.startswith("norm"):
        return f"transformer_blocks.0.{sub}"
    return {"ff_geglu": "transformer_blocks.0.ff.net.0.proj",
            "ff_out": "transformer_blocks.0.ff.net.2"}[sub]


def _unet_key(parts, ucfg) -> str:
    p = "model.diffusion_model"
    kind = _kind(parts[-1])
    nrb = ucfg.num_res_blocks
    fixed = {"time_embed_0": "time_embed.0", "time_embed_2": "time_embed.2",
             "in_conv": "input_blocks.0.0", "out_norm": "out.0", "out_conv": "out.2"}
    head = parts[0]
    if head in fixed:
        return f"{p}.{fixed[head]}.{kind}"
    toks = head.split("_")
    if toks[0] == "mid":
        if toks[1] == "res":
            return f"{p}.middle_block.{0 if toks[2] == '0' else 2}.{_UNET_RES[parts[1]]}.{kind}"
        return f"{p}.middle_block.1.{_unet_attn(parts[1:])}.{kind}"
    lv = int(toks[1])
    if toks[0] == "down":
        if toks[2] == "downsample":
            return f"{p}.input_blocks.{1 + lv * (nrb + 1) + nrb}.0.op.{kind}"
        idx = 1 + lv * (nrb + 1) + int(toks[3])
        if toks[2] == "res":
            return f"{p}.input_blocks.{idx}.0.{_UNET_RES[parts[1]]}.{kind}"
        return f"{p}.input_blocks.{idx}.1.{_unet_attn(parts[1:])}.{kind}"
    r = len(ucfg.ch_mult) - 1 - lv
    if toks[2] == "upsample":
        sub = 2 if lv in ucfg.attention_levels else 1
        return f"{p}.output_blocks.{r * (nrb + 1) + nrb}.{sub}.conv.{kind}"
    idx = r * (nrb + 1) + int(toks[3])
    if toks[2] == "res":
        return f"{p}.output_blocks.{idx}.0.{_UNET_RES[parts[1]]}.{kind}"
    return f"{p}.output_blocks.{idx}.1.{_unet_attn(parts[1:])}.{kind}"


def _text_encoder(flat: Dict[str, np.ndarray], sd: Dict[str, torch.Tensor]) -> None:
    """HF CLIPTextModel names; SD's text encoder has no text_projection, so
    the tower's is not written (the converter supplies identity)."""
    p = "cond_stage_model.transformer.text_model"
    for name, a in flat.items():
        parts = name.split("/")
        if parts[0] == "token_embedding":
            sd[f"{p}.embeddings.token_embedding.weight"] = _t(a)
        elif parts[0] == "positional_embedding":
            sd[f"{p}.embeddings.position_embedding.weight"] = _t(a)
        elif parts[0] == "ln_final":
            sd[f"{p}.final_layer_norm.{_kind(parts[1])}"] = _t(a)
        elif parts[0] == "transformer":
            s = f"{p}.encoder.layers.{parts[1].split('_')[1]}"
            kind = _kind(parts[-1])
            w = a.T if parts[-1] == "kernel" else a
            if parts[2] == "attn" and parts[3] == "in_proj":
                for nm, v in zip("qkv", np.split(w, 3, axis=0)):
                    sd[f"{s}.self_attn.{nm}_proj.{kind}"] = _t(v)
            elif parts[2] == "attn":
                sd[f"{s}.self_attn.out_proj.{kind}"] = _t(w)
            else:
                sub = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "mlp_c_fc": "mlp.fc1",
                       "mlp_c_proj": "mlp.fc2"}[parts[2]]
                sd[f"{s}.{sub}.{kind}"] = _t(w)


def sd_state_dict(ldm: nn.Module) -> Dict[str, torch.Tensor]:
    """The SD v1 checkpoint's `state_dict` of an LDM extractor
    (`models/ldm_extractor.py` `LdmExtractor`)."""
    flat = flat_weights(ldm)["params"]
    sd: Dict[str, torch.Tensor] = {}
    text = {}
    for path, a in flat.items():
        parts = path.split("/")
        if parts[0] == "vae":
            if parts[-1] == "kernel" and a.ndim == 2:  # quant convs: 1x1 convs in the file
                sd[_vae_key(parts[1:])] = _t(a.T[:, :, None, None])
            else:
                sd[_vae_key(parts[1:])] = _t(
                    _dense_or_conv(a) if parts[-1] == "kernel" else a)
        elif parts[0] == "unet":
            sd[_unet_key(parts[1:], ldm.cfg.unet)] = _t(
                _dense_or_conv(a) if parts[-1] == "kernel" else a)
        elif parts[0] == "text_encoder":
            text["/".join(parts[1:])] = a
        # shared_noise: no released file holds it
    _text_encoder(text, sd)
    return sd


# --------------------------------------------------------------------------- #
# open_clip
# --------------------------------------------------------------------------- #


def open_clip_state_dict(clip: nn.Module) -> Dict[str, torch.Tensor]:
    """The open_clip ViT state dict of a CLIP (`models/clip.py` `CLIP`)."""
    flat = flat_weights(clip)["params"]
    sd: Dict[str, torch.Tensor] = {}
    top = {"text/token_embedding": "token_embedding.weight",
           "text/positional_embedding": "positional_embedding",
           "text/text_projection": "text_projection",
           "visual/class_embedding": "visual.class_embedding",
           "visual/positional_embedding": "visual.positional_embedding",
           "visual/proj": "visual.proj", "logit_scale": "logit_scale"}
    for rest, a in flat.items():
        parts = rest.split("/")
        if rest in top:
            sd[top[rest]] = _t(a)
        elif parts[1] == "transformer":
            src = ("visual." if parts[0] == "visual" else "") \
                + f"transformer.resblocks.{parts[2].split('_')[1]}"
            w = a.T if parts[-1] == "kernel" else a
            if parts[3] == "attn" and parts[4] == "in_proj":
                sd[f"{src}.attn.in_proj_{_kind(parts[-1])}"] = _t(w)
            elif parts[3] == "attn":
                sd[f"{src}.attn.out_proj.{_kind(parts[-1])}"] = _t(w)
            else:
                sub = {"ln_1": "ln_1", "ln_2": "ln_2", "mlp_c_fc": "mlp.c_fc",
                       "mlp_c_proj": "mlp.c_proj"}[parts[3]]
                sd[f"{src}.{sub}.{_kind(parts[-1])}"] = _t(w)
        else:  # conv1, ln_pre, ln_post, ln_final
            src = ("visual." if parts[0] == "visual" else "") + parts[1]
            sd[f"{src}.{_kind(parts[-1])}"] = _t(
                _dense_or_conv(a) if parts[-1] == "kernel" else a)
    return sd


# --------------------------------------------------------------------------- #
# the released XMask3D trainables
# --------------------------------------------------------------------------- #


def _me_kernel(a: np.ndarray) -> np.ndarray:
    """The port's (K, C_in, C_out) sparse kernel in ME's layout: offsets in
    ME's order (the first axis fastest), kernel size 1 as (C_in, C_out)."""
    if a.shape[0] == 1:
        return a[0]
    k = round(a.shape[0] ** (1 / 3))
    if k ** 3 != a.shape[0]:
        return a
    me = np.empty_like(a)
    for xi in range(k):
        for yi in range(k):
            for zi in range(k):
                me[zi * k * k + yi * k + xi] = a[xi * k * k + yi * k + zi]
    return me


_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _mink_key(parts) -> str:
    """Path under MinkUNet_0 (without the leaf) -> the MinkUNetBase module."""
    head = parts[0]
    m = re.fullmatch(r"(conv|convtr)(\d)", head)
    if head == "conv0":
        return "conv0p1s1"
    if m and m[1] == "conv":
        s = int(m[2]) - 1
        return f"conv{s + 1}p{2 ** s}s2"
    if m:
        d = int(m[2]) - 4
        return f"convtr{4 + d}p{2 ** (4 - d)}s2"
    if head == "final":
        return "final"
    if re.fullmatch(r"bn\d|bntr\d", head):
        return f"{head}.bn"
    m = re.fullmatch(r"block(\d)_(\d+)", head)
    sub = {"conv1": "conv1", "norm1": "norm1.bn", "conv2": "conv2", "norm2": "norm2.bn",
           "downsample_conv": "downsample.0", "downsample_norm": "downsample.1.bn"}[parts[1]]
    return f"block{m[1]}.{m[2]}.{sub}"


def _trainable_key(parts):
    """A trainable's flat path (without the leaf) -> (torch module name,
    is a BatchNorm), or None where it is assembled elsewhere."""
    head = parts[0]
    if head in ("pc_decoder", "pc_binary_head"):
        if parts[1] == "MinkUNet_0":
            mod = _mink_key(parts[2:])
            return f"{head}.encoder.{mod}", mod.endswith(".bn")
        sub = {"bn": "batch_norm"}.get(parts[1], parts[1])
        return f"{head}.{sub}", parts[1] == "bn"
    if head == "backbone":
        if parts[1] == "feature_extractor":
            return "backbone.feature_extractor." + ".".join(parts[2:]), False
        i = parts[1].split("_")[1]
        src = f"backbone.feature_projections.{i}.0"
        m = re.fullmatch(r"norm(\d)", parts[2])
        if m:
            return f"{src}.conv{m[1]}.norm", False
        return f"{src}.{'shortcut.norm' if parts[2] == 'shortcut_norm' else parts[2]}", False
    if head == "pixel_decoder":
        pd = "sem_seg_head.pixel_decoder"
        sub = parts[1]
        m = re.fullmatch(r"(input_proj|input_norm)_(\d)", sub)
        if m:
            return f"{pd}.input_proj.{m[2]}.{0 if m[1] == 'input_proj' else 1}", False
        m = re.fullmatch(r"encoder_layer_(\d+)", sub)
        if m:
            s = f"{pd}.transformer.encoder.layers.{m[1]}"
            if parts[2] in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
                return f"{s}.self_attn.{parts[2]}", False
            return f"{s}.{parts[2]}", False
        named = {"adapter_1": "adapter_1", "adapter_norm_1": "adapter_1.norm",
                 "layer_1": "layer_1", "layer_norm_1": "layer_1.norm",
                 "mask_features": "mask_features"}
        return f"{pd}.{named[sub]}", False
    if head == "mask_decoder":
        md = "sem_seg_head.predictor"
        sub = parts[1]
        m = re.fullmatch(r"layer_(\d+)", sub)
        if m:
            li = m[1]
            ca = f"{md}.transformer_cross_attention_layers.{li}"
            sa = f"{md}.transformer_self_attention_layers.{li}"
            ff = f"{md}.transformer_ffn_layers.{li}"
            if parts[2] in ("cross_attn", "self_attn"):
                if parts[3] != "out_proj":
                    return None  # q/k/v: packed into in_proj below
                base = (f"{ca}.multihead_attn" if parts[2] == "cross_attn"
                        else f"{sa}.self_attn")
                return f"{base}.out_proj", False
            return {"norm1": f"{ca}.norm", "norm2": f"{sa}.norm", "norm3": f"{ff}.norm",
                    "ffn1": f"{ff}.linear1", "ffn2": f"{ff}.linear2"}[parts[2]], False
        if sub == "mask_embed_mlp":
            return f"{md}.mask_embed.layers.{parts[2].split('_')[1]}", False
        if sub == "post_mask_embed":
            pme = f"{md}.post_mask_embed"
            if parts[2] == "embed_mlp":
                return f"{pme}.mask_embed.1.layers.{parts[3].split('_')[1]}", False
            return f"{pme}." + {"pool_norm": "pool_proj.0", "pool_proj": "pool_proj.1",
                                "embed_norm": "mask_embed.0"}[parts[2]], False
        return f"{md}.decoder_norm", False
    if head == "fuser":
        return "criterion.fuser.linear", False
    raise KeyError("/".join(parts))


def xmask3d_state_dict(model: nn.Module, eos_coef: float = 0.1,
                       pos_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """The released checkpoint's `state_dict` (no `module.` prefix) of an
    XMask3D model's trainables: every key of `tests/ref_state_dict.py`'s
    manifest."""
    flat = flat_weights(model, lambda p: not (p.startswith(LDM + "/") or p.startswith("clip/")))
    sd: Dict[str, torch.Tensor] = {}
    level_embed, packed = {}, {}
    md = "sem_seg_head.predictor"
    pme = f"{md}.post_mask_embed"
    whole = {  # leaves that are a tensor of their own in the file
        "backbone/feature_extractor/clip_project/positional_embedding":
            "backbone.feature_extractor.clip_project.positional_embedding",
        "backbone/feature_extractor/time_embed_project/positional_embedding":
            "backbone.feature_extractor.time_embed_project.positional_embedding",
        "backbone/feature_extractor/alpha_cond": "backbone.feature_extractor.alpha_cond",
        "backbone/feature_extractor/alpha_cond_time_embed":
            "backbone.feature_extractor.alpha_cond_time_embed",
        "mask_decoder/query_feat": f"{md}.query_feat.weight",
        "mask_decoder/query_embed": f"{md}.query_embed.weight",
        "mask_decoder/level_embed": f"{md}.level_embed.weight",
        "mask_decoder/post_mask_embed/logit_scale": f"{pme}.logit_scale",
        "category_embed/null_embed": "category_head.null_embed",
    }
    for col in ("params", "batch_stats"):
        for path, a in flat[col].items():
            parts = path.split("/")
            if path in whole:
                sd[whole[path]] = _t(a)
                continue
            m = re.fullmatch(r"pixel_decoder/level_embed_(\d)", path)
            if m:
                level_embed[int(m[1])] = a
                continue
            key = _trainable_key(parts[:-1])
            leaf = parts[-1]
            if key is None:  # mask decoder q/k/v
                attn = "multihead_attn" if parts[2] == "cross_attn" else "self_attn"
                layers = ("transformer_cross_attention_layers" if parts[2] == "cross_attn"
                          else "transformer_self_attention_layers")
                base = f"{md}.{layers}.{parts[1].split('_')[1]}.{attn}"
                packed.setdefault((base, leaf), {})[parts[3][0]] = a.T if leaf == "kernel" else a
                continue
            mod, is_bn = key
            if is_bn:
                sd[f"{mod}.{_BN_LEAF[leaf]}"] = _t(a)
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            elif leaf == "kernel" and a.ndim == 3:
                sd[f"{mod}.kernel"] = _t(_me_kernel(a))
            elif leaf == "kernel":
                sd[f"{mod}.weight"] = _t(_dense_or_conv(a))
            else:
                sd[f"{mod}.{_kind(leaf)}"] = _t(a)
    sd["sem_seg_head.pixel_decoder.transformer.level_embed"] = _t(
        np.stack([level_embed[i] for i in sorted(level_embed)]))
    for (base, leaf), qkv in packed.items():
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        sd[f"{base}.{name}"] = _t(np.concatenate([qkv["q"], qkv["k"], qkv["v"]], 0))
    # the loss buffers of the reference's module, which the converter skips
    n_cls = model.cfg.num_classes
    sd["criterion.empty_weight"] = torch.cat([torch.ones(n_cls), torch.tensor([eos_coef])])
    sd["binary_loss_func.pos_weight"] = torch.tensor([pos_weight])
    return sd


def released_checkpoint(state_dict: Dict[str, torch.Tensor], epoch: int = 0) -> dict:
    """The b15n4.pth.tar layout: DDP's `module.` prefix on every key."""
    return {"epoch": epoch, "state_dict": {f"module.{k}": v for k, v in state_dict.items()},
            "optimizer": {}, "best_iou": 0.0}


def write_released(model: nn.Module, directory: str) -> Dict[str, str]:
    """The model's weights as the three released files under `directory`:
    {"sd": an SD v1 CompVis checkpoint, "clip": an open_clip state dict,
    "xmask3d": a b15n4.pth.tar-layout checkpoint}, fp32, one at a time."""
    ldm = model.backbone.feature_extractor.ldm_extractor
    paths = {"sd": os.path.join(directory, "sd-v1.ckpt"),
             "clip": os.path.join(directory, "open_clip.pt"),
             "xmask3d": os.path.join(directory, "xmask3d.pth.tar")}
    torch.save({"state_dict": sd_state_dict(ldm), "global_step": 0}, paths["sd"])
    torch.save(open_clip_state_dict(model.clip), paths["clip"])
    torch.save(released_checkpoint(xmask3d_state_dict(model, model.cfg.eos_coef)),
               paths["xmask3d"])
    return paths
