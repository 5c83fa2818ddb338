"""The port's side of a run, shared by the traffic kinds' code: its
configuration held to the configuration file, and the seed's views and
tokens in the sizes the model takes."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.traffic.views import VOXEL_SIZE, caption_tokens, empty_caption, rng_for, view_arrays

VIEW_STREAM, TOKEN_STREAM = 100, 1


def model_shape(conf: Dict, tiny: bool) -> Dict:
    """Sizes of the views, tokens and images the model takes."""
    if tiny:
        return {"image_size": (64, 64), "context_length": 16, "vocab_size": 512}
    return {"image_size": tuple(conf["image_size"]), "context_length": conf["context_length"],
            "vocab_size": conf["vocab_size"]}


def draw_views(seed: int, conf: Dict, traffic: Dict, tiny: bool, n: int) -> List[Dict]:
    """n views of the traffic mix, each from its own stream of the seed."""
    shp = model_shape(conf, tiny)
    return [view_arrays(rng_for(seed, VIEW_STREAM + i), traffic["points_per_view"],
                        conf["classes"], shp["image_size"], conf["mask_shape"],
                        shp["context_length"], shp["vocab_size"],
                        tuple(traffic.get("rectangles", (2, 6))))
            for i in range(n)]


def draw_tokens(seed: int, conf: Dict, tiny: bool) -> Dict[str, np.ndarray]:
    shp = model_shape(conf, tiny)
    rng = rng_for(seed, TOKEN_STREAM)
    t, v = shp["context_length"], shp["vocab_size"]
    return {"train": caption_tokens(rng, conf["classes"], t, v),
            "test": caption_tokens(rng, conf["test_classes"], t, v),
            "uncond": empty_caption(t, v)}


def caps_of(conf: Dict, traffic: Dict) -> Dict:
    return {"max_points": traffic["max_points"], "max_voxels": traffic["max_voxels"],
            "max_targets": conf["max_targets"]}


def port_config(conf: Dict, tiny: bool):
    """The port's configuration from the yaml the configuration file names,
    held to the file's numbers: a key that differs stops the run."""
    from xmask3d_tpu_torch.config import load_config

    from benchmark.harness.core import ROOT

    cfg = load_config(str(ROOT / conf["yaml"]))
    cs = cfg.category_split
    got = {"classes": cfg.classes, "test_classes": cfg.test_classes,
           "num_queries": cfg.num_queries, "arch_3d": cfg.arch_3d,
           "arch_binary_head": cfg.arch_binary_head, "mask_shape": list(cfg.mask_shape),
           "base_category": list(cs.base_category), "novel_category": list(cs.novel_category),
           "ignore_category": list(cs.ignore_category), "ignore_label": cfg.ignore_label,
           "data_ratio": cfg.data_ratio, "binary_2d_thresh": cfg.binary_2d_thresh,
           "scores_keep_thresh": cfg.scores_keep_thresh, "base_ratio": cfg.base_ratio,
           "novel_ratio": cfg.novel_ratio, "compute_dtype": cfg.compute_dtype,
           "remat_backbone": bool(cfg.remat_backbone), "max_targets": cfg.max_targets,
           "clip_name": cfg.clip_name, "dec_layers": cfg.get("dec_layers", 9),
           "pixel_enc_layers": cfg.get("pixel_enc_layers", 6)}
    for k, v in got.items():
        want = conf[k]
        if tiny and k in ("mask_shape", "arch_3d", "arch_binary_head", "dec_layers",
                          "pixel_enc_layers", "compute_dtype", "clip_name"):
            setattr(cfg, k, want)
            continue
        if v != want:
            raise SystemExit(f"the port's {conf['yaml']} gives {k}={v!r}, the configuration "
                             f"file {want!r}")
    return cfg


def port_samples(raws: List[Dict], caps: Dict):
    """The views through the port's voxelizer into its `ViewSample`s, and
    the port's capacities, for its collation."""
    from xmask3d_tpu_torch.data.batching import Capacities, ViewSample
    from xmask3d_tpu_torch.data.voxelizer import Voxelizer

    mv = caps["max_voxels"]
    samples = []
    for r in raws:
        coords, feats, _, inds = Voxelizer(voxel_size=VOXEL_SIZE).voxelize(
            r["points"], r["colors"], r["labels_vox"])
        samples.append(ViewSample(
            voxel_coords=coords[:mv], voxel_feats=(feats[:mv] / 127.5 - 1.0).astype(np.float32),
            inds_reconstruct=np.clip(inds, 0, mv - 1), labels_3d=r["labels_3d"],
            binary_label_3d=r["binary_label_3d"], x_label=r["x_label"], y_label=r["y_label"],
            img=r["img"], label_2d=r["label_2d"], binary_label_2d=r["binary_label_2d"],
            caption_tokens=r["caption_tokens"]))
    return samples, Capacities(max_points=caps["max_points"], max_voxels=mv,
                               max_targets=caps["max_targets"])


def statics_of(model, tokens: Dict[str, np.ndarray], device) -> Dict:
    """The frozen inputs of every forward, through `model`'s own CLIP text
    tower (the port's or the reference's): the text banks of the train and
    test label names and the empty prompt's tokens."""
    import torch

    def embed(t):
        return model.embed_captions(torch.from_numpy(t).to(device))

    with torch.no_grad():
        return {"text_embed_train": embed(tokens["train"]), "text_embed_test": embed(tokens["test"]),
                "uncond_tokens": torch.from_numpy(tokens["uncond"]).to(device)}
