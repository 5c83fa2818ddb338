"""Torch checkpoints in the released layouts -> flat weights in the JAX
package's layout: the port's own copy of `xmask3d_tpu/checkpoint/convert_torch.py`.

Covers the reference's checkpoint formats:
1. Stable Diffusion `sd-v1-*.ckpt` (CompVis layout: model.diffusion_model.*,
   first_stage_model.*, cond_stage_model.*) -> the VAE, UNet and text
   encoder weights of the LDM extractor.
2. open_clip / OpenAI CLIP ViT state dicts -> the CLIP weights.
3. MinkowskiEngine sparse kernels, for `convert_xmask3d.py`.

The output is the JAX converters' `{"a/b/c": ndarray}` in flax layout,
byte for byte: torch Conv (O,I,kh,kw) -> (kh,kw,I,O); Linear (O,I) ->
(I,O); packed qkv rows -> packed columns. So the npz that
`tools/convert_checkpoints.py` writes is the file the JAX package's script
writes, and the port loads it through `checkpoint/load_converted.py` and
the weight bridge's rules (`checkpoint/from_jax.py` `_rule`).

MinkowskiEngine sparse kernels are already (K, C_in, C_out); only the
kernel-offset order is permuted (ME iterates the first axis fastest, the
port the last: see `me_offset_permutation`). That order follows ME 0.5's
kernel_region.hpp; it is pinned only by the JAX package's
tests/test_golden_reference.py::test_me_offset_permutation_semantics, which
needs the reference sources, so no run without them checks it against
MinkowskiEngine. The port's tests hold it equal to the JAX permutation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


def conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def lin_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def me_offset_permutation(k: int) -> np.ndarray:
    """Permutation p with ours[i] = me[p[i]] for kernel size k (3D).

    Our offsets enumerate the last axis fastest (np.ndindex); ME's region
    iterator enumerates the first axis fastest.
    """
    n = k**3
    p = np.zeros(n, np.int64)
    for xi in range(k):
        for yi in range(k):
            for zi in range(k):
                ours = xi * k * k + yi * k + zi
                me = zi * k * k + yi * k + xi
                p[ours] = me
    return p


# --------------------------------------------------------------------------- #
# Stable Diffusion v1 ckpt
# --------------------------------------------------------------------------- #


def _convert_resnet_block(sd: Dict[str, np.ndarray], src: str, dst: str, out):
    pairs = [
        ("norm1", "norm1"), ("conv1", "conv1"), ("norm2", "norm2"),
        ("conv2", "conv2"), ("nin_shortcut", "nin_shortcut"),
    ]
    for s, d in pairs:
        wk = f"{src}.{s}.weight"
        if wk not in sd:
            continue
        w = sd[wk]
        if w.ndim == 4:
            out[f"{dst}/{d}/kernel"] = conv_w(w)
            out[f"{dst}/{d}/bias"] = sd[f"{src}.{s}.bias"]
        else:  # GroupNorm
            out[f"{dst}/{d}/scale"] = w
            out[f"{dst}/{d}/bias"] = sd[f"{src}.{s}.bias"]


def _convert_attn_block(sd, src, dst, out):
    out[f"{dst}/norm/scale"] = sd[f"{src}.norm.weight"]
    out[f"{dst}/norm/bias"] = sd[f"{src}.norm.bias"]
    for name in ["q", "k", "v", "proj_out"]:
        out[f"{dst}/{name}/kernel"] = conv_w(sd[f"{src}.{name}.weight"])
        out[f"{dst}/{name}/bias"] = sd[f"{src}.{name}.bias"]


def convert_sd_vae(sd: Dict[str, np.ndarray], ch_mult=(1, 2, 4, 4), num_res_blocks=2):
    """first_stage_model.* -> AutoencoderKL params (models/vae.py names)."""
    out: Dict[str, np.ndarray] = {}
    p = "first_stage_model"
    n_lv = len(ch_mult)
    for enc in ["encoder", "decoder"]:
        e = f"{p}.{enc}"
        out[f"{enc}/conv_in/kernel"] = conv_w(sd[f"{e}.conv_in.weight"])
        out[f"{enc}/conv_in/bias"] = sd[f"{e}.conv_in.bias"]
        for blk in ["mid_block_1", "mid_block_2"]:
            _convert_resnet_block(
                sd, f"{e}.mid.{blk.replace('mid_', '')}", f"{enc}/{blk}", out
            )
        _convert_attn_block(sd, f"{e}.mid.attn_1", f"{enc}/mid_attn_1", out)
        out[f"{enc}/norm_out/scale"] = sd[f"{e}.norm_out.weight"]
        out[f"{enc}/norm_out/bias"] = sd[f"{e}.norm_out.bias"]
        out[f"{enc}/conv_out/kernel"] = conv_w(sd[f"{e}.conv_out.weight"])
        out[f"{enc}/conv_out/bias"] = sd[f"{e}.conv_out.bias"]

    for lv in range(n_lv):
        for b in range(num_res_blocks):
            _convert_resnet_block(
                sd, f"{p}.encoder.down.{lv}.block.{b}", f"encoder/down_{lv}_block_{b}", out
            )
        if lv != n_lv - 1:
            out[f"encoder/down_{lv}_downsample/conv/kernel"] = conv_w(
                sd[f"{p}.encoder.down.{lv}.downsample.conv.weight"]
            )
            out[f"encoder/down_{lv}_downsample/conv/bias"] = sd[
                f"{p}.encoder.down.{lv}.downsample.conv.bias"
            ]
        for b in range(num_res_blocks + 1):
            _convert_resnet_block(
                sd, f"{p}.decoder.up.{lv}.block.{b}", f"decoder/up_{lv}_block_{b}", out
            )
        if lv != 0:
            out[f"decoder/up_{lv}_upsample/conv/kernel"] = conv_w(
                sd[f"{p}.decoder.up.{lv}.upsample.conv.weight"]
            )
            out[f"decoder/up_{lv}_upsample/conv/bias"] = sd[
                f"{p}.decoder.up.{lv}.upsample.conv.bias"
            ]

    # quant convs are 1x1 convs mapped to Dense
    out["quant_conv/kernel"] = lin_w(sd[f"{p}.quant_conv.weight"][:, :, 0, 0])
    out["quant_conv/bias"] = sd[f"{p}.quant_conv.bias"]
    out["post_quant_conv/kernel"] = lin_w(sd[f"{p}.post_quant_conv.weight"][:, :, 0, 0])
    out["post_quant_conv/bias"] = sd[f"{p}.post_quant_conv.bias"]
    return out


def _convert_unet_resblock(sd, src, dst, out):
    out[f"{dst}/in_norm/scale"] = sd[f"{src}.in_layers.0.weight"]
    out[f"{dst}/in_norm/bias"] = sd[f"{src}.in_layers.0.bias"]
    out[f"{dst}/in_conv/kernel"] = conv_w(sd[f"{src}.in_layers.2.weight"])
    out[f"{dst}/in_conv/bias"] = sd[f"{src}.in_layers.2.bias"]
    out[f"{dst}/emb_proj/kernel"] = lin_w(sd[f"{src}.emb_layers.1.weight"])
    out[f"{dst}/emb_proj/bias"] = sd[f"{src}.emb_layers.1.bias"]
    out[f"{dst}/out_norm/scale"] = sd[f"{src}.out_layers.0.weight"]
    out[f"{dst}/out_norm/bias"] = sd[f"{src}.out_layers.0.bias"]
    out[f"{dst}/out_conv/kernel"] = conv_w(sd[f"{src}.out_layers.3.weight"])
    out[f"{dst}/out_conv/bias"] = sd[f"{src}.out_layers.3.bias"]
    if f"{src}.skip_connection.weight" in sd:
        out[f"{dst}/skip/kernel"] = conv_w(sd[f"{src}.skip_connection.weight"])
        out[f"{dst}/skip/bias"] = sd[f"{src}.skip_connection.bias"]


def _convert_spatial_transformer(sd, src, dst, out):
    out[f"{dst}/norm/scale"] = sd[f"{src}.norm.weight"]
    out[f"{dst}/norm/bias"] = sd[f"{src}.norm.bias"]
    for pn in ["proj_in", "proj_out"]:
        out[f"{dst}/{pn}/kernel"] = conv_w(sd[f"{src}.{pn}.weight"])
        out[f"{dst}/{pn}/bias"] = sd[f"{src}.{pn}.bias"]
    tb = f"{src}.transformer_blocks.0"
    db = f"{dst}/block_0"
    for attn in ["attn1", "attn2"]:
        for proj in ["to_q", "to_k", "to_v"]:
            out[f"{db}/{attn}/{proj}/kernel"] = lin_w(sd[f"{tb}.{attn}.{proj}.weight"])
        out[f"{db}/{attn}/to_out/kernel"] = lin_w(sd[f"{tb}.{attn}.to_out.0.weight"])
        out[f"{db}/{attn}/to_out/bias"] = sd[f"{tb}.{attn}.to_out.0.bias"]
    for i in [1, 2, 3]:
        out[f"{db}/norm{i}/scale"] = sd[f"{tb}.norm{i}.weight"]
        out[f"{db}/norm{i}/bias"] = sd[f"{tb}.norm{i}.bias"]
    out[f"{db}/ff_geglu/proj/kernel"] = lin_w(sd[f"{tb}.ff.net.0.proj.weight"])
    out[f"{db}/ff_geglu/proj/bias"] = sd[f"{tb}.ff.net.0.proj.bias"]
    out[f"{db}/ff_out/kernel"] = lin_w(sd[f"{tb}.ff.net.2.weight"])
    out[f"{db}/ff_out/bias"] = sd[f"{tb}.ff.net.2.bias"]


def convert_sd_unet(
    sd: Dict[str, np.ndarray],
    ch_mult=(1, 2, 4, 4),
    num_res_blocks=2,
    attention_levels=(0, 1, 2),
):
    """model.diffusion_model.* -> SDUNet params (models/sd_unet.py names)."""
    out: Dict[str, np.ndarray] = {}
    p = "model.diffusion_model"
    out["time_embed_0/kernel"] = lin_w(sd[f"{p}.time_embed.0.weight"])
    out["time_embed_0/bias"] = sd[f"{p}.time_embed.0.bias"]
    out["time_embed_2/kernel"] = lin_w(sd[f"{p}.time_embed.2.weight"])
    out["time_embed_2/bias"] = sd[f"{p}.time_embed.2.bias"]
    out["in_conv/kernel"] = conv_w(sd[f"{p}.input_blocks.0.0.weight"])
    out["in_conv/bias"] = sd[f"{p}.input_blocks.0.0.bias"]

    n_lv = len(ch_mult)
    idx = 1
    for lv in range(n_lv):
        for i in range(num_res_blocks):
            src = f"{p}.input_blocks.{idx}"
            _convert_unet_resblock(sd, f"{src}.0", f"down_{lv}_res_{i}", out)
            if lv in attention_levels:
                _convert_spatial_transformer(sd, f"{src}.1", f"down_{lv}_attn_{i}", out)
            idx += 1
        if lv != n_lv - 1:
            out[f"down_{lv}_downsample/kernel"] = conv_w(
                sd[f"{p}.input_blocks.{idx}.0.op.weight"]
            )
            out[f"down_{lv}_downsample/bias"] = sd[f"{p}.input_blocks.{idx}.0.op.bias"]
            idx += 1

    _convert_unet_resblock(sd, f"{p}.middle_block.0", "mid_res_0", out)
    _convert_spatial_transformer(sd, f"{p}.middle_block.1", "mid_attn", out)
    _convert_unet_resblock(sd, f"{p}.middle_block.2", "mid_res_1", out)

    idx = 0
    for r, lv in enumerate(reversed(range(n_lv))):
        for i in range(num_res_blocks + 1):
            src = f"{p}.output_blocks.{idx}"
            _convert_unet_resblock(sd, f"{src}.0", f"up_{lv}_res_{i}", out)
            sub = 1
            if lv in attention_levels:
                _convert_spatial_transformer(sd, f"{src}.{sub}", f"up_{lv}_attn_{i}", out)
                sub += 1
            if lv != 0 and i == num_res_blocks:
                out[f"up_{lv}_upsample/kernel"] = conv_w(
                    sd[f"{src}.{sub}.conv.weight"]
                )
                out[f"up_{lv}_upsample/bias"] = sd[f"{src}.{sub}.conv.bias"]
            idx += 1

    out["out_norm/scale"] = sd[f"{p}.out.0.weight"]
    out["out_norm/bias"] = sd[f"{p}.out.0.bias"]
    out["out_conv/kernel"] = conv_w(sd[f"{p}.out.2.weight"])
    out["out_conv/bias"] = sd[f"{p}.out.2.bias"]
    return out


def convert_sd_text_encoder(sd: Dict[str, np.ndarray], layers: int = 12):
    """cond_stage_model.* (HF CLIPTextModel) -> CLIPTextTower params."""
    out: Dict[str, np.ndarray] = {}
    p = "cond_stage_model.transformer.text_model"
    out["token_embedding"] = sd[f"{p}.embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd[f"{p}.embeddings.position_embedding.weight"]
    for i in range(layers):
        s = f"{p}.encoder.layers.{i}"
        d = f"transformer/resblock_{i}"
        qw, kw, vw = (sd[f"{s}.self_attn.{n}_proj.weight"] for n in "qkv")
        qb, kb, vb = (sd[f"{s}.self_attn.{n}_proj.bias"] for n in "qkv")
        out[f"{d}/attn/in_proj/kernel"] = lin_w(np.concatenate([qw, kw, vw], 0))
        out[f"{d}/attn/in_proj/bias"] = np.concatenate([qb, kb, vb], 0)
        out[f"{d}/attn/out_proj/kernel"] = lin_w(sd[f"{s}.self_attn.out_proj.weight"])
        out[f"{d}/attn/out_proj/bias"] = sd[f"{s}.self_attn.out_proj.bias"]
        out[f"{d}/ln_1/scale"] = sd[f"{s}.layer_norm1.weight"]
        out[f"{d}/ln_1/bias"] = sd[f"{s}.layer_norm1.bias"]
        out[f"{d}/ln_2/scale"] = sd[f"{s}.layer_norm2.weight"]
        out[f"{d}/ln_2/bias"] = sd[f"{s}.layer_norm2.bias"]
        out[f"{d}/mlp_c_fc/kernel"] = lin_w(sd[f"{s}.mlp.fc1.weight"])
        out[f"{d}/mlp_c_fc/bias"] = sd[f"{s}.mlp.fc1.bias"]
        out[f"{d}/mlp_c_proj/kernel"] = lin_w(sd[f"{s}.mlp.fc2.weight"])
        out[f"{d}/mlp_c_proj/bias"] = sd[f"{s}.mlp.fc2.bias"]
    out["ln_final/scale"] = sd[f"{p}.final_layer_norm.weight"]
    out["ln_final/bias"] = sd[f"{p}.final_layer_norm.bias"]
    # SD's text encoder has no text_projection; our tower's projection stays
    # identity-initialized and unused on the conditioning path (encodings
    # only). Supply identity to be explicit.
    width = out["ln_final/scale"].shape[0]
    out["text_projection"] = np.eye(width, dtype=np.float32)
    return out


def convert_sd_checkpoint(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    sd = load_torch_state(path)
    return {
        "vae": convert_sd_vae(sd),
        "unet": convert_sd_unet(sd),
        "text_encoder": convert_sd_text_encoder(sd),
    }


# --------------------------------------------------------------------------- #
# open_clip / OpenAI CLIP
# --------------------------------------------------------------------------- #


def convert_open_clip(sd: Dict[str, np.ndarray], text_layers=12, vision_layers=24):
    """open_clip ViT state dict -> models/clip.CLIP params (flat)."""
    out: Dict[str, np.ndarray] = {}

    def tower(prefix_src, prefix_dst, layers):
        for i in range(layers):
            s = f"{prefix_src}transformer.resblocks.{i}"
            d = f"{prefix_dst}transformer/resblock_{i}"
            out[f"{d}/attn/in_proj/kernel"] = lin_w(sd[f"{s}.attn.in_proj_weight"])
            out[f"{d}/attn/in_proj/bias"] = sd[f"{s}.attn.in_proj_bias"]
            out[f"{d}/attn/out_proj/kernel"] = lin_w(sd[f"{s}.attn.out_proj.weight"])
            out[f"{d}/attn/out_proj/bias"] = sd[f"{s}.attn.out_proj.bias"]
            for ln in ["ln_1", "ln_2"]:
                out[f"{d}/{ln}/scale"] = sd[f"{s}.{ln}.weight"]
                out[f"{d}/{ln}/bias"] = sd[f"{s}.{ln}.bias"]
            out[f"{d}/mlp_c_fc/kernel"] = lin_w(sd[f"{s}.mlp.c_fc.weight"])
            out[f"{d}/mlp_c_fc/bias"] = sd[f"{s}.mlp.c_fc.bias"]
            out[f"{d}/mlp_c_proj/kernel"] = lin_w(sd[f"{s}.mlp.c_proj.weight"])
            out[f"{d}/mlp_c_proj/bias"] = sd[f"{s}.mlp.c_proj.bias"]

    # text tower
    out["text/token_embedding"] = sd["token_embedding.weight"]
    out["text/positional_embedding"] = sd["positional_embedding"]
    tower("", "text/", text_layers)
    out["text/ln_final/scale"] = sd["ln_final.weight"]
    out["text/ln_final/bias"] = sd["ln_final.bias"]
    out["text/text_projection"] = sd["text_projection"]
    # vision tower
    out["visual/conv1/kernel"] = conv_w(sd["visual.conv1.weight"])
    out["visual/class_embedding"] = sd["visual.class_embedding"]
    out["visual/positional_embedding"] = sd["visual.positional_embedding"]
    out["visual/ln_pre/scale"] = sd["visual.ln_pre.weight"]
    out["visual/ln_pre/bias"] = sd["visual.ln_pre.bias"]
    tower("visual.", "visual/", vision_layers)
    out["visual/ln_post/scale"] = sd["visual.ln_post.weight"]
    out["visual/ln_post/bias"] = sd["visual.ln_post.bias"]
    out["visual/proj"] = sd["visual.proj"]
    out["logit_scale"] = sd["logit_scale"].reshape(())
    return out


# --------------------------------------------------------------------------- #
# MinkowskiEngine sparse kernels (used by the xmask3d trainable converter)
# --------------------------------------------------------------------------- #


def convert_me_kernel(w: np.ndarray) -> np.ndarray:
    """(K, Cin, Cout) ME kernel -> ours, permuting offset order.

    ME stores kernel-size-1 kernels as 2-D (Cin, Cout); our SparseConv
    keeps the offset axis, so those become (1, Cin, Cout)
    (caught by tests/test_checkpoint_e2e.py load-shape check)."""
    if w.ndim == 2:  # kernel_size=1
        return w[None]
    k3 = w.shape[0]
    k = round(k3 ** (1 / 3))
    if k**3 != k3:
        return w
    return w[me_offset_permutation(k)]
