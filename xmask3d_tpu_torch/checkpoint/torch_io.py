"""Checkpoint save and restore of a training run (`torch.save` files).

Counterpart of `xmask3d_tpu/checkpoint/orbax_io.py` `Checkpointer`: a
checkpoint holds the trainable parameters (the optimizer's fp32 masters),
the BatchNorm running statistics, the optimizer state and {step, best_iou};
the frozen parameters are not saved and keep the values they have when a
checkpoint is restored. One file a step, `step_<step>.pt`, at most
`max_to_keep` of them.

Under a model axis (`parallel/tensor.py`) `save` gathers every sharded
master and its AdamW moments into whole tensors (a collective of the first
data replica's model group; the other ranks return at once) and rank 0
writes them, so a checkpoint is the same file whatever the mesh; `restore`
keeps this rank's slice of each, by the current mesh, and
`restore_for_serving` loads a file into a whole model with no group.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from xmask3d_tpu_torch.engine.builder import label_tree
from xmask3d_tpu_torch.parallel.mesh import data_rank, rank
from xmask3d_tpu_torch.parallel.tensor import gather_tensor, shard_tensor, sharded_tensors

_FILE = re.compile(r"step_(\d+)\.pt$")


def _orbax_steps(directory: str):
    """The steps of orbax checkpoints in `directory`: subdirectories named
    by their step that hold orbax's `_CHECKPOINT_METADATA`."""
    return sorted(int(f) for f in os.listdir(directory) if f.isdigit()
                  and os.path.isfile(os.path.join(directory, f, "_CHECKPOINT_METADATA")))


def _trainable(state):
    """{dotted name: (parameter, master)} of the trainable parameters."""
    labels = label_tree(state.model)
    params = dict(state.model.named_parameters())
    masters = {id(p): m for pairs in state.optimizer.pairs.values() for p, m in pairs}
    return {name: (params[name], masters[id(params[name])])
            for name, lab in labels.items() if lab != "frozen"}


def _moment_names(state):
    """The dotted parameter name of each index of the optimizer's state
    dict (its masters in group order)."""
    name = {id(p): n for n, p in state.model.named_parameters()}
    return [name[id(p)] for pairs in state.optimizer.pairs.values() for p, _ in pairs]


def _moments(opt, state, shards, layout):
    """An optimizer state dict with each sharded master's moments passed
    through `layout(tensor, dim, packs)`: made whole (`gather_tensor`) or
    cut to this rank's slice (`shard_tensor`)."""
    if not shards:
        return opt
    names = _moment_names(state)
    opt["state"] = {i: {k: layout(v, *shards[names[i]])
                        if names[i] in shards and k.startswith("exp_avg") else v
                        for k, v in st.items()} for i, st in opt["state"].items()}
    return opt


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _FILE.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state, best_iou: float = 0.0, extra: Optional[dict] = None) -> None:
        """Write the checkpoint of `step` (rank 0; under a model axis every
        rank calls it, for the gathers)."""
        if data_rank() != 0:
            return
        shards = sharded_tensors(state.model)

        def whole(name, m):
            return gather_tensor(m, *shards[name]) if name in shards else m.detach()

        payload = {
            "trainable": {n: whole(n, m).cpu() for n, (_, m) in _trainable(state).items()},
            "batch_stats": {n: b.detach().cpu() for n, b in state.model.named_buffers()},
            "opt_state": _moments(state.optimizer.state_dict(), state, shards, gather_tensor),
            "meta": {"step": int(step), "best_iou": float(best_iou), **(extra or {})},
        }
        if rank() != 0:
            return
        self.write(step, payload)

    def write(self, step: int, payload: dict) -> None:
        """Write a checkpoint payload as the file of `step` (through a
        temporary file), keeping the newest `max_to_keep` files."""
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _load(self, step: Optional[int]) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            if _orbax_steps(self.directory):
                raise FileNotFoundError(
                    f"{self.directory} holds a JAX run's orbax checkpoints; convert them "
                    "first: python scripts/orbax_to_torch.py --config <config> --src "
                    f"{self.directory} --dst <dir> (on a machine with orbax)")
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None) -> Tuple[object, dict]:
        """Load a checkpoint (the latest unless `step` is given) into a built
        `TrainState`: masters and parameters, buffers, optimizer state and
        the step count. Returns (state, meta)."""
        payload = self._load(step)
        trainable = _trainable(state)
        if set(payload["trainable"]) != set(trainable):
            raise KeyError("checkpoint and model have different trainable parameters")
        shards = sharded_tensors(state.model)

        def mine(name, full):
            return shard_tensor(full, *shards[name]) if name in shards else full

        with torch.no_grad():
            for name, (p, m) in trainable.items():
                m.copy_(mine(name, payload["trainable"][name]))
                if m is not p:
                    p.copy_(m)
            buffers = dict(state.model.named_buffers())
            for name, value in payload["batch_stats"].items():
                buffers[name].copy_(value)
        state.optimizer.load_state_dict(_moments(payload["opt_state"], state, shards,
                                                 shard_tensor))
        state.step = int(payload["meta"]["step"])
        return state, payload["meta"]

    def restore_for_serving(self, model, step: Optional[int] = None) -> dict:
        """Load a checkpoint (the latest unless `step` is given) into a
        serving model: each master into its parameter, cast to the
        parameter's (compute) dtype, and the BatchNorm statistics; the frozen
        parameters keep their values, as in `restore`. Returns the meta."""
        payload = self._load(step)
        labels = label_tree(model)
        params = dict(model.named_parameters())
        trainable = {n for n, lab in labels.items() if lab != "frozen"}
        if set(payload["trainable"]) != trainable:
            raise KeyError("checkpoint and model have different trainable parameters")
        buffers = dict(model.named_buffers())
        if set(payload["batch_stats"]) != set(buffers):
            raise KeyError("checkpoint and model have different buffers")
        with torch.no_grad():
            for name, master in payload["trainable"].items():
                params[name].copy_(master)
            for name, value in payload["batch_stats"].items():
                buffers[name].copy_(value)
        return payload["meta"]
