"""Weight bridge from the JAX package's variables to the port's modules.

`load_jax_variables(module, variables)` takes the JAX `{"params",
"batch_stats"}` tree as nested dicts of numpy arrays and fills the module's
parameters and buffers. The port keeps flax's module names, so a torch key
`a.b.c.weight` comes from the JAX path `a/b/c/<leaf>` with a fixed rule per
layer type:

  nn.Linear          weight <- kernel (in, out) transposed, bias <- bias
  layers.Conv        weight <- kernel HWIO as OIHW, bias <- bias
  LayerNorm/GroupNorm weight <- scale, bias <- bias
  MaskedBatchNorm    scale, bias <- params; mean, var <- batch_stats
  anything else      the leaf of the same name, as it is (sparse kernels
                     (K, C_in, C_out), shared_noise, alpha_cond, logit_scale)

Every JAX leaf must be consumed and every port tensor filled, with equal
shapes; anything else raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from xmask3d_tpu_torch.models.layers import Conv, GroupNorm


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _rule(mod: nn.Module, name: str) -> Tuple[str, str, Any]:
    """(collection, jax leaf name, transform) for a module's tensor."""
    if isinstance(mod, nn.Linear):
        if name == "weight":
            return "params", "kernel", lambda a: a.T
    elif isinstance(mod, Conv):
        if name == "weight":
            return "params", "kernel", lambda a: a.transpose(3, 2, 0, 1)
    elif isinstance(mod, (nn.LayerNorm, GroupNorm)):
        if name == "weight":
            return "params", "scale", None
    if name in ("mean", "var"):
        return "batch_stats", name, None
    return "params", name, None


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill `module`'s parameters and buffers from JAX variables (numpy)."""
    flat = {
        col: _flatten(variables.get(col, {})) for col in ("params", "batch_stats")
    }
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected variable collections: {sorted(extra)}")
    used = {col: set() for col in flat}
    missing, bad_shape = [], []
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            tensors = list(mod.named_parameters(recurse=False)) \
                + list(mod.named_buffers(recurse=False))
            for name, t in tensors:
                col, leaf, fn = _rule(mod, name)
                path = "/".join(p for p in (mod_name.replace(".", "/"), leaf) if p)
                if path not in flat[col]:
                    missing.append(f"{col}/{path}")
                    continue
                used[col].add(path)
                arr = flat[col][path]
                if fn is not None:
                    arr = fn(arr)
                if tuple(arr.shape) != tuple(t.shape):
                    bad_shape.append(f"{col}/{path}: {arr.shape} vs {tuple(t.shape)}")
                    continue
                t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
    unused = [f"{c}/{p}" for c in flat for p in sorted(set(flat[c]) - used[c])]
    if missing or unused or bad_shape:
        raise KeyError(
            "JAX variables do not match the module: "
            f"{len(missing)} missing {missing[:8]}, {len(unused)} unused "
            f"{unused[:8]}, {len(bad_shape)} shape mismatches {bad_shape[:8]}"
        )
