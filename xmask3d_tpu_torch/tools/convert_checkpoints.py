"""Released weights -> one npz of converted weights, with no JAX and no yaml.

The port's counterpart of `scripts/convert_checkpoints.py`, with the same
flags and the same npz: the released XMask3D trainables
(`b15n4.pth.tar`), the SD v1 checkpoint (`sd-v1-3.ckpt`) and open_clip
ViT-L/14, through the port's converters (`checkpoint/convert_torch.py`,
`checkpoint/convert_xmask3d.py`), written as flat `params/<a/b/c>` and
`batch_stats/<a/b/c>` arrays. It runs on the host only.

    python -m xmask3d_tpu_torch.tools.convert_checkpoints \\
        --xmask3d b15n4.pth.tar --sd sd-v1-3.ckpt --clip ViT-L-14.pt \\
        --out converted_b15n4.npz

Any subset of the three may be given; `sd://` and `odise://` names resolve
in the model-zoo cache (`utils/model_zoo.py`, `XMASK3D_MODEL_ZOO`). The
whole-scene CLI serves the result:
`python -m xmask3d_tpu_torch.engine.infer_cli --config ... --converted converted_b15n4.npz`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from xmask3d_tpu_torch.checkpoint.convert_torch import (
    convert_open_clip,
    convert_sd_checkpoint,
    load_torch_state,
)
from xmask3d_tpu_torch.checkpoint.convert_xmask3d import convert_xmask3d_checkpoint
from xmask3d_tpu_torch.utils.model_zoo import resolve

# where the SD towers sit in the model's weights
LDM = "backbone/feature_extractor/ldm_extractor"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("xmask3d_tpu_torch checkpoint conversion")
    p.add_argument("--xmask3d", default="", help="released trainables (b15n4.pth.tar layout)")
    p.add_argument("--sd", default="", help="SD v1 checkpoint (CompVis layout)")
    p.add_argument("--clip", default="", help="open_clip ViT state dict")
    p.add_argument("--arch_3d", default="MinkUNet34C")
    p.add_argument("--arch_binary", default="MinkUNet18A")
    p.add_argument("--out", required=True)
    return p


def main(argv=None) -> dict:
    """Convert, write `--out`; returns {"params": n, "batch_stats": n}."""
    args = get_parser().parse_args(argv)
    params, stats = {}, {}
    if args.sd:
        sd = convert_sd_checkpoint(resolve(args.sd))
        for mod, tree in sd.items():
            for k, v in tree.items():
                params[f"{LDM}/{mod}/{k}"] = v
        print(f"SD: {sum(len(t) for t in sd.values())} tensors")
    if args.clip:
        clip = convert_open_clip(load_torch_state(resolve(args.clip)))
        for k, v in clip.items():
            params[f"clip/{k}"] = v
        print(f"CLIP: {len(clip)} tensors")
    if args.xmask3d:
        tp, ts = convert_xmask3d_checkpoint(
            resolve(args.xmask3d), arch_3d=args.arch_3d, arch_binary=args.arch_binary,
        )
        params.update(tp)
        stats.update(ts)
        print(f"XMask3D trainables: {len(tp)} params, {len(ts)} stats")

    np.savez(
        args.out,
        **{f"params/{k}": v for k, v in params.items()},
        **{f"batch_stats/{k}": v for k, v in stats.items()},
    )
    print(f"wrote {args.out}: {len(params)} params, {len(stats)} batch stats")
    return {"params": len(params), "batch_stats": len(stats)}


if __name__ == "__main__":
    main(sys.argv[1:])
