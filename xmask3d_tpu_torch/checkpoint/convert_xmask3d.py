"""Released XMask3D checkpoint (b15n4.pth.tar etc.) -> the trainable
weights: the port's own copy of `xmask3d_tpu/checkpoint/convert_xmask3d.py`.

Maps the reference's torch module names (pc_decoder / pc_binary_head /
backbone.feature_* / sem_seg_head pixel decoder + predictor /
category_head / criterion.fuser) onto the JAX package's flat names, which
the port's modules keep. Checkpoints follow the {epoch, state_dict,
optimizer, best_iou} format with DDP's `module.` prefixes; the frozen CLIP
and SD weights are absent from them and come from their own files
(`convert_torch.py`).

MinkowskiEngine kernels are (K, C_in, C_out) like the port's, modulo the
offset permutation (`convert_torch.me_offset_permutation`, not checked
against MinkowskiEngine by any run without the reference sources).
BatchNorm: torch (weight, bias, running_mean, running_var) -> (scale, bias)
params + (mean, var) batch_stats.

Returns (params_flat, batch_stats_flat) dicts of {"a/b/c": np.ndarray}. A
key the checkpoint lacks raises KeyError.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from xmask3d_tpu_torch.checkpoint.convert_torch import (
    conv_w,
    convert_me_kernel,
    lin_w,
    load_torch_state,
)


def _strip(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def _me_bn(sd, src, dst, params, stats):
    """ME.MinkowskiBatchNorm / torch BN (possibly SyncBN-converted names)."""
    # ME BN nests as `<name>.bn.<param>`; torch BN as `<name>.<param>`
    base = f"{src}.bn" if f"{src}.bn.weight" in sd else src
    params[f"{dst}/scale"] = sd[f"{base}.weight"]
    params[f"{dst}/bias"] = sd[f"{base}.bias"]
    stats[f"{dst}/mean"] = sd[f"{base}.running_mean"]
    stats[f"{dst}/var"] = sd[f"{base}.running_var"]


def _me_conv(sd, src, dst, params):
    params[f"{dst}/kernel"] = convert_me_kernel(np.asarray(sd[f"{src}.kernel"]))


def _linear(sd, src, dst, params, bias=True):
    params[f"{dst}/kernel"] = lin_w(sd[f"{src}.weight"])
    if bias and f"{src}.bias" in sd:
        params[f"{dst}/bias"] = sd[f"{src}.bias"]


def _mink_unet(sd, src, dst, layers, params, stats):
    """MinkUNetBase (reference mink_unet.py:44-116) -> models/minkunet.py."""
    _me_conv(sd, f"{src}.conv0p1s1", f"{dst}/conv0", params)
    _me_bn(sd, f"{src}.bn0", f"{dst}/bn0", params, stats)
    for s in range(4):
        _me_conv(sd, f"{src}.conv{s + 1}p{2**s}s2", f"{dst}/conv{s + 1}", params)
        _me_bn(sd, f"{src}.bn{s + 1}", f"{dst}/bn{s + 1}", params, stats)
    for d in range(4):
        _me_conv(sd, f"{src}.convtr{4 + d}p{2**(4 - d)}s2", f"{dst}/convtr{4 + d}", params)
        _me_bn(sd, f"{src}.bntr{4 + d}", f"{dst}/bntr{4 + d}", params, stats)
    for blk in range(8):
        for i in range(layers[blk]):
            sblk = f"{src}.block{blk + 1}.{i}"
            dblk = f"{dst}/block{blk + 1}_{i}"
            _me_conv(sd, f"{sblk}.conv1", f"{dblk}/conv1", params)
            _me_bn(sd, f"{sblk}.norm1", f"{dblk}/norm1", params, stats)
            _me_conv(sd, f"{sblk}.conv2", f"{dblk}/conv2", params)
            _me_bn(sd, f"{sblk}.norm2", f"{dblk}/norm2", params, stats)
            if f"{sblk}.downsample.0.kernel" in sd:
                _me_conv(sd, f"{sblk}.downsample.0", f"{dblk}/downsample_conv", params)
                _me_bn(sd, f"{sblk}.downsample.1", f"{dblk}/downsample_norm", params, stats)
    _me_conv(sd, f"{src}.final", f"{dst}/final", params)


_LAYERS = {"MinkUNet34C": (2, 3, 4, 6, 2, 2, 2, 2), "MinkUNet18A": (2,) * 8}


def convert_xmask3d_checkpoint(
    path_or_state, arch_3d="MinkUNet34C", arch_binary="MinkUNet18A",
    n_taps: int = 8, dec_layers: int = 9,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    sd = (
        _strip(load_torch_state(path_or_state))
        if isinstance(path_or_state, str)
        else _strip(path_or_state)
    )
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}

    # 3D branches (pc_processor.py:6-60)
    _mink_unet(sd, "pc_decoder.encoder", "pc_decoder/MinkUNet_0",
               _LAYERS[arch_3d], params, stats)
    _linear(sd, "pc_decoder.point2text_adapter", "pc_decoder/point2text_adapter", params)
    _linear(sd, "pc_decoder.decoder", "pc_decoder/decoder", params)
    _mink_unet(sd, "pc_binary_head.encoder", "pc_binary_head/MinkUNet_0",
               _LAYERS[arch_binary], params, stats)
    _me_bn(sd, "pc_binary_head.batch_norm", "pc_binary_head/bn", params, stats)
    _linear(sd, "pc_binary_head.fc", "pc_binary_head/fc", params)

    # backbone projections + implicit captioner adapters
    for i in range(n_taps):
        src = f"backbone.feature_projections.{i}.0"
        dst = f"backbone/proj_{i}"
        for conv, norm in [("conv1", "norm1"), ("conv2", "norm2"), ("conv3", "norm3")]:
            params[f"{dst}/{conv}/kernel"] = conv_w(sd[f"{src}.{conv}.weight"])
            params[f"{dst}/{norm}/scale"] = sd[f"{src}.{conv}.norm.weight"]
            params[f"{dst}/{norm}/bias"] = sd[f"{src}.{conv}.norm.bias"]
        if f"{src}.shortcut.weight" in sd:
            params[f"{dst}/shortcut/kernel"] = conv_w(sd[f"{src}.shortcut.weight"])
            params[f"{dst}/shortcut_norm/scale"] = sd[f"{src}.shortcut.norm.weight"]
            params[f"{dst}/shortcut_norm/bias"] = sd[f"{src}.shortcut.norm.bias"]

    fx = "backbone.feature_extractor"
    ic = "backbone/feature_extractor"
    _linear(sd, f"{fx}.clip_project.linear", f"{ic}/clip_project/linear", params)
    params[f"{ic}/clip_project/positional_embedding"] = sd[
        f"{fx}.clip_project.positional_embedding"
    ]
    params[f"{ic}/alpha_cond"] = sd[f"{fx}.alpha_cond"]
    _linear(sd, f"{fx}.time_embed_project.linear", f"{ic}/time_embed_project/linear", params)
    params[f"{ic}/time_embed_project/positional_embedding"] = sd[
        f"{fx}.time_embed_project.positional_embedding"
    ]
    params[f"{ic}/alpha_cond_time_embed"] = sd[f"{fx}.alpha_cond_time_embed"]

    convert_pixel_decoder(sd, params)

    convert_mask_decoder(sd, params, dec_layers=dec_layers)

    # category head + fuser
    params["category_embed/null_embed"] = np.asarray(
        sd["category_head.null_embed"]
    ).reshape(1, -1)
    _linear(sd, "criterion.fuser.linear", "fuser/linear", params)

    return params, stats


def convert_pixel_decoder(
    sd,
    params: Dict[str, np.ndarray],
    enc_layers: int = 6,
    pd_src: str = "sem_seg_head.pixel_decoder",
    pd: str = "pixel_decoder",
) -> None:
    """Pixel-decoder section (msdeformattn.py:232-358) — factored out so
    golden tests can convert a standalone reference decoder's state_dict."""
    for i in range(3):
        params[f"{pd}/input_proj_{i}/kernel"] = conv_w(
            sd[f"{pd_src}.input_proj.{i}.0.weight"]
        )
        params[f"{pd}/input_proj_{i}/bias"] = sd[f"{pd_src}.input_proj.{i}.0.bias"]
        params[f"{pd}/input_norm_{i}/scale"] = sd[f"{pd_src}.input_proj.{i}.1.weight"]
        params[f"{pd}/input_norm_{i}/bias"] = sd[f"{pd_src}.input_proj.{i}.1.bias"]
        params[f"{pd}/level_embed_{i}"] = np.asarray(sd[f"{pd_src}.transformer.level_embed"])[i]
    for li in range(enc_layers):
        s = f"{pd_src}.transformer.encoder.layers.{li}"
        d = f"{pd}/encoder_layer_{li}"
        _linear(sd, f"{s}.self_attn.sampling_offsets", f"{d}/sampling_offsets", params)
        _linear(sd, f"{s}.self_attn.attention_weights", f"{d}/attention_weights", params)
        _linear(sd, f"{s}.self_attn.value_proj", f"{d}/value_proj", params)
        _linear(sd, f"{s}.self_attn.output_proj", f"{d}/output_proj", params)
        for ln_s, ln_d in [("norm1", "norm1"), ("norm2", "norm2")]:
            params[f"{d}/{ln_d}/scale"] = sd[f"{s}.{ln_s}.weight"]
            params[f"{d}/{ln_d}/bias"] = sd[f"{s}.{ln_s}.bias"]
        _linear(sd, f"{s}.linear1", f"{d}/linear1", params)
        _linear(sd, f"{s}.linear2", f"{d}/linear2", params)
    params[f"{pd}/adapter_1/kernel"] = conv_w(sd[f"{pd_src}.adapter_1.weight"])
    params[f"{pd}/adapter_norm_1/scale"] = sd[f"{pd_src}.adapter_1.norm.weight"]
    params[f"{pd}/adapter_norm_1/bias"] = sd[f"{pd_src}.adapter_1.norm.bias"]
    params[f"{pd}/layer_1/kernel"] = conv_w(sd[f"{pd_src}.layer_1.weight"])
    params[f"{pd}/layer_norm_1/scale"] = sd[f"{pd_src}.layer_1.norm.weight"]
    params[f"{pd}/layer_norm_1/bias"] = sd[f"{pd_src}.layer_1.norm.bias"]
    params[f"{pd}/mask_features/kernel"] = conv_w(sd[f"{pd_src}.mask_features.weight"])
    params[f"{pd}/mask_features/bias"] = sd[f"{pd_src}.mask_features.bias"]


def convert_mask_decoder(
    sd,
    params: Dict[str, np.ndarray],
    dec_layers: int = 9,
    md_src: str = "sem_seg_head.predictor",
    md: str = "mask_decoder",
) -> None:
    """Predictor section (odise.py:329-597 /
    mask2former_transformer_decoder.py) — factored out so golden tests can
    convert a standalone reference decoder's state_dict."""
    params[f"{md}/query_feat"] = sd[f"{md_src}.query_feat.weight"]
    params[f"{md}/query_embed"] = sd[f"{md_src}.query_embed.weight"]
    params[f"{md}/level_embed"] = sd[f"{md_src}.level_embed.weight"]
    for li in range(dec_layers):
        d = f"{md}/layer_{li}"
        ca = f"{md_src}.transformer_cross_attention_layers.{li}"
        sa = f"{md_src}.transformer_self_attention_layers.{li}"
        ff = f"{md_src}.transformer_ffn_layers.{li}"
        for torch_attn, dst_attn in [(ca, "cross_attn"), (sa, "self_attn")]:
            w = np.asarray(sd[f"{torch_attn}.multihead_attn.in_proj_weight"]
                           if f"{torch_attn}.multihead_attn.in_proj_weight" in sd
                           else sd[f"{torch_attn}.self_attn.in_proj_weight"])
            b = np.asarray(sd[f"{torch_attn}.multihead_attn.in_proj_bias"]
                           if f"{torch_attn}.multihead_attn.in_proj_bias" in sd
                           else sd[f"{torch_attn}.self_attn.in_proj_bias"])
            qw, kw, vw = np.split(w, 3, 0)
            qb, kb, vb = np.split(b, 3, 0)
            out_src = (f"{torch_attn}.multihead_attn.out_proj"
                       if f"{torch_attn}.multihead_attn.out_proj.weight" in sd
                       else f"{torch_attn}.self_attn.out_proj")
            params[f"{d}/{dst_attn}/q_proj/kernel"] = lin_w(qw)
            params[f"{d}/{dst_attn}/q_proj/bias"] = qb
            params[f"{d}/{dst_attn}/k_proj/kernel"] = lin_w(kw)
            params[f"{d}/{dst_attn}/k_proj/bias"] = kb
            params[f"{d}/{dst_attn}/v_proj/kernel"] = lin_w(vw)
            params[f"{d}/{dst_attn}/v_proj/bias"] = vb
            _linear(sd, out_src, f"{d}/{dst_attn}/out_proj", params)
        # reference layer norms: cross(norm), self(norm), ffn(norm)
        params[f"{d}/norm1/scale"] = sd[f"{ca}.norm.weight"]
        params[f"{d}/norm1/bias"] = sd[f"{ca}.norm.bias"]
        params[f"{d}/norm2/scale"] = sd[f"{sa}.norm.weight"]
        params[f"{d}/norm2/bias"] = sd[f"{sa}.norm.bias"]
        params[f"{d}/norm3/scale"] = sd[f"{ff}.norm.weight"]
        params[f"{d}/norm3/bias"] = sd[f"{ff}.norm.bias"]
        _linear(sd, f"{ff}.linear1", f"{d}/ffn1", params)
        _linear(sd, f"{ff}.linear2", f"{d}/ffn2", params)
    params[f"{md}/decoder_norm/scale"] = sd[f"{md_src}.decoder_norm.weight"]
    params[f"{md}/decoder_norm/bias"] = sd[f"{md_src}.decoder_norm.bias"]
    for i in range(3):
        _linear(sd, f"{md_src}.mask_embed.layers.{i}", f"{md}/mask_embed_mlp/layer_{i}", params)
    pme = f"{md_src}.post_mask_embed"
    params[f"{md}/post_mask_embed/pool_norm/scale"] = sd[f"{pme}.pool_proj.0.weight"]
    params[f"{md}/post_mask_embed/pool_norm/bias"] = sd[f"{pme}.pool_proj.0.bias"]
    _linear(sd, f"{pme}.pool_proj.1", f"{md}/post_mask_embed/pool_proj", params)
    params[f"{md}/post_mask_embed/embed_norm/scale"] = sd[f"{pme}.mask_embed.0.weight"]
    params[f"{md}/post_mask_embed/embed_norm/bias"] = sd[f"{pme}.mask_embed.0.bias"]
    for i in range(3):
        _linear(sd, f"{pme}.mask_embed.1.layers.{i}",
                f"{md}/post_mask_embed/embed_mlp/layer_{i}", params)
    params[f"{md}/post_mask_embed/logit_scale"] = np.asarray(
        sd[f"{pme}.logit_scale"]
    ).reshape(())
