"""Converted weights (the npz `tools/convert_checkpoints.py` writes, and the
JAX package's `scripts/convert_checkpoints.py` too) into the port's modules.

The port's own copy of `xmask3d_tpu/checkpoint/load_converted.py`: the npz
holds flat JAX paths, `params/<a/b/c>` and `batch_stats/<a/b/c>`, as numpy
arrays (the released XMask3D trainables, SD v1 and open_clip through the
converters, `checkpoint/convert_torch.py` and `convert_xmask3d.py`). Each
port tensor takes its path and layout from the weight bridge's rules (`checkpoint/from_jax.py` `bridge_tensors`), as a partial
update: the JAX `apply_flat_updates` semantics, so converted tensors with
no destination are skipped, a shape mismatch raises, and tensors the npz
does not hold keep their values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from xmask3d_tpu_torch.checkpoint.from_jax import bridge_tensors


def load_converted_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """({path: array} of params, {path: array} of batch_stats)."""
    params, stats = {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("params/"):
                params[k[len("params/"):]] = data[k]
            elif k.startswith("batch_stats/"):
                stats[k[len("batch_stats/"):]] = data[k]
    return params, stats


def apply_flat_updates(module: nn.Module, flat: Dict[str, Dict[str, np.ndarray]]
                       ) -> Dict[str, List[str]]:
    """Write {collection: {jax path: array}} into `module`'s parameters and
    buffers through the bridge's name rules. Returns the applied paths per
    collection; a path missing from them had no destination."""
    applied: Dict[str, List[str]] = {col: [] for col in flat}
    with torch.no_grad():
        for col, path, _, _, t, fn in bridge_tensors(module):
            arr = flat.get(col, {}).get(path)
            if arr is None:
                continue
            if fn is not None:
                arr = fn(arr)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {col}/{path}: converted "
                                 f"{tuple(arr.shape)} vs model {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
            applied[col].append(path)
    return applied


def apply_converted(module: nn.Module, path: str) -> Tuple[List[str], List[str]]:
    """Load the npz at `path` into `module`; returns (applied param paths,
    applied batch_stats paths)."""
    params, stats = load_converted_npz(path)
    applied = apply_flat_updates(module, {"params": params, "batch_stats": stats})
    return applied["params"], applied["batch_stats"]
