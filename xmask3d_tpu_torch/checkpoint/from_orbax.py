"""A JAX training run's checkpoint as a checkpoint of the port's trainer.

The JAX trainer saves through `xmask3d_tpu/checkpoint/orbax_io.py`
`Checkpointer`: one orbax item a step holding

  trainable    {"a/b/c": array}, the trainable parameters by flax path
  batch_stats  the BatchNorm running statistics, nested by flax path
  opt_state    optax `multi_transform` state: inner_states[group].inner_state
               is adamw's chain, (ScaleByAdamState{count, mu, nu},
               EmptyState, ScaleByScheduleState{count}), each tree over all
               parameters with the other groups' leaves masked
  meta         {"step", "best_iou"}

`orbax_payload(tree, model, optimizer)` takes that item read into nested
dicts and lists of numpy arrays (orbax restored without a template gives
optax's NamedTuple states as dicts, its chains as lists and the masked
leaves as None; the
reader is `scripts/orbax_to_torch.py`, which needs orbax and so JAX) and
returns what `checkpoint/torch_io.py` `Checkpointer` writes for a model
built from the same config:

  - each trainable parameter as its fp32 master under the port's name, in
    the port's layout (`from_jax.bridge_tensors`: Dense transposed, Conv
    HWIO -> OIHW, ...);
  - the BatchNorm statistics as the buffers `load_jax_variables` fills;
  - AdamW's `mu` and `nu` of the "3d" and "others" groups as `exp_avg` /
    `exp_avg_sq`, with their parameter's relayout, at the index the port's
    optimizer gives the parameter's master (`torch_io._moment_names`), and
    each group's adam `count` as every one of its parameters' `step`
    (torch's AdamW corrects the bias by it, as optax does by its count);
  - `meta` as it is.

optax's adamw and `torch.optim.AdamW` are the same update (decoupled decay
scaled by the learning rate, bias correction by the count), so the run goes
on where it stopped. `model` and `optimizer` may live on the `meta` device:
only their names, groups and shapes are read.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Mapping

import numpy as np
import torch

from xmask3d_tpu_torch.checkpoint.from_jax import _flatten, bridge_tensors
from xmask3d_tpu_torch.checkpoint.torch_io import _moment_names
from xmask3d_tpu_torch.engine.builder import label_tree
from xmask3d_tpu_torch.engine.train_step import GROUPS


def _adam_state(opt_state: Mapping[str, Any], group: str) -> Mapping[str, Any]:
    """{count, mu, nu} of `group`'s ScaleByAdamState in its chain (a list)."""
    for st in opt_state["inner_states"][group]["inner_state"]:
        if isinstance(st, Mapping) and "mu" in st and "nu" in st:
            return st
    raise KeyError(f"no adam state in the optimizer state of group {group!r}")


def _first_difference(a, b) -> str:
    only_a, only_b = sorted(set(a) - set(b)), sorted(set(b) - set(a))
    if only_a:
        return f"{only_a[0]!r} is trainable in the JAX run but not in the port"
    return f"{only_b[0]!r} is trainable in the port but not in the JAX run"


def orbax_payload(tree: Mapping[str, Any], model: torch.nn.Module, optimizer) -> Dict[str, Any]:
    """The `torch_io` checkpoint payload of the JAX checkpoint `tree` for
    `model` and its `MasterAdamW` `optimizer` (see the module docstring)."""
    labels = label_tree(model)
    names = {id(m): n for n, m in model.named_modules()}
    # JAX path -> (port name, layout transform, torch shape), per collection
    bridge: Dict[str, Dict[str, tuple]] = {"params": {}, "batch_stats": {}}
    for bt in bridge_tensors(model):
        name = ".".join(p for p in (names[id(bt.module)], bt.name) if p)
        if bt.collection == "params" and labels[name] == "frozen":
            continue
        bridge[bt.collection][bt.path] = (name, bt.transform, tuple(bt.tensor.shape))

    def port(path: str, arr, col: str = "params") -> torch.Tensor:
        name, fn, shape = bridge[col][path]
        arr = np.asarray(arr)
        if fn is not None:
            arr = fn(arr)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: JAX shape {arr.shape} does not lay out as {shape}")
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    trainable = {str(k): v for k, v in tree["trainable"].items()}
    if set(trainable) != set(bridge["params"]):
        raise KeyError("trainable parameters differ: "
                       + _first_difference(trainable, bridge["params"]))
    stats = _flatten(tree["batch_stats"])
    if set(stats) != set(bridge["batch_stats"]):
        raise KeyError("BatchNorm statistics differ: "
                       + _first_difference(stats, bridge["batch_stats"]))

    by_name = {bridge["params"][p][0]: p for p in trainable}
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for g in GROUPS:
        adam = _adam_state(tree["opt_state"], g)
        mu, nu = (_flatten(_drop_masked(adam[k])) for k in ("mu", "nu"))
        count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
        members = sorted(p for p in trainable if labels[bridge["params"][p][0]] == g)
        if set(mu) != set(members) or set(nu) != set(members):
            raise KeyError(f"group {g!r}: " + _first_difference(mu, members))
        for p in members:
            moments[p] = {"step": count.clone(), "exp_avg": port(p, mu[p]),
                          "exp_avg_sq": port(p, nu[p])}

    opt = optimizer.state_dict()
    names = _moment_names(SimpleNamespace(model=model, optimizer=optimizer))
    opt["state"] = {i: moments[by_name[n]] for i, n in enumerate(names)}
    meta = dict(tree["meta"])
    return {
        "trainable": {bridge["params"][p][0]: port(p, a) for p, a in trainable.items()},
        "batch_stats": {bridge["batch_stats"][p][0]: port(p, a, "batch_stats")
                        for p, a in stats.items()},
        "opt_state": opt,
        "meta": {**meta, "step": int(np.asarray(meta["step"])),
                 "best_iou": float(np.asarray(meta.get("best_iou", 0.0)))},
    }


def _drop_masked(tree):
    """The tree without the leaves optax masked for another group (None)."""
    if isinstance(tree, Mapping):
        out = {k: _drop_masked(v) for k, v in tree.items() if v is not None}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return tree
