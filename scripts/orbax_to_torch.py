"""Convert a JAX training run's orbax checkpoint into one the port reads.

    python scripts/orbax_to_torch.py --config configs/scannet/xmask3d_scannet_B15N4.yaml \
        --src <jax save_path>/model --dst <port save_path>/model [--step N] [--tiny] [KEY VALUE ...]

Reads the JAX trainer's `<save_path>/model` directory (written by
`xmask3d_tpu/checkpoint/orbax_io.py`) at `--step`, the newest by default,
with orbax and no template, maps it onto the port's model and optimizer
for the same config and overrides (`xmask3d_tpu_torch/checkpoint/
from_orbax.py`; the model is built on the `meta` device, so no weights
are allocated) and writes `step_<n>.pt` into `--dst`. The port's
`python -m xmask3d_tpu_torch.engine.infer_cli --ckpt <dst>` serves it and
its trainer's `--save_path <parent of dst> --resume 1` goes on training
from it. Trainable parameters, BatchNorm statistics, AdamW's moments and
counts, the step and best_iou carry over; the frozen towers are not in the
checkpoint, as in the JAX run.

It needs `orbax.checkpoint` (and so JAX) but imports nothing of the JAX
package; run it where orbax is installed, then copy `--dst` to the GPU
machine, which needs neither.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xmask3d_tpu_torch.checkpoint.from_orbax import orbax_payload  # noqa: E402
from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer  # noqa: E402
from xmask3d_tpu_torch.config import load_config  # noqa: E402
from xmask3d_tpu_torch.engine.builder import model_config_from_cfg  # noqa: E402
from xmask3d_tpu_torch.engine.train_step import make_optimizer  # noqa: E402
from xmask3d_tpu_torch.models.xmask3d import XMask3D  # noqa: E402


def _numpy(tree: Any) -> Any:
    """Nested dicts and lists with every array leaf as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if tree is None or isinstance(tree, (int, float, str)):
        return tree
    return np.asarray(tree)


def read_orbax(src: str, step: Optional[int] = None):
    """(step, the checkpoint item as nested dicts and lists of numpy arrays)."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(src))
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no orbax checkpoint in {src}")
    return step, _numpy(mgr.restore(step, args=ocp.args.StandardRestore()))


def convert(src: str, dst: str, config: str, opts: Sequence[str] = (), tiny: bool = False,
            step: Optional[int] = None):
    """Convert the checkpoint of `step` (the newest by default) under `src`;
    returns (the path written, the orbax item as read)."""
    cfg = load_config(config, list(opts))
    with torch.device("meta"):
        model = XMask3D(model_config_from_cfg(cfg, tiny=tiny))
    optimizer = make_optimizer(model, cfg.lr_3d, cfg.lr_others, 1)
    step, tree = read_orbax(src, step)
    payload = orbax_payload(tree, model, optimizer)
    ck = Checkpointer(dst)
    ck.write(payload["meta"]["step"], payload)
    return ck._path(payload["meta"]["step"]), tree


def main(argv=None) -> str:
    p = argparse.ArgumentParser("orbax_to_torch")
    p.add_argument("--config", required=True)
    p.add_argument("--src", required=True, help="the JAX run's <save_path>/model")
    p.add_argument("--dst", required=True, help="the port's checkpoint directory")
    p.add_argument("--step", type=int, default=None, help="default: the newest")
    p.add_argument("--tiny", action="store_true", help="the tiny model variant")
    p.add_argument("opts", nargs="*", help="KEY VALUE override pairs, as the trainer takes")
    args = p.parse_args(argv)
    path, _ = convert(args.src, args.dst, args.config, args.opts, args.tiny, args.step)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
