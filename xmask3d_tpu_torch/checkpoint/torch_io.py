"""Checkpoint save and restore of a training run (`torch.save` files).

Counterpart of `xmask3d_tpu/checkpoint/orbax_io.py` `Checkpointer`: a
checkpoint holds the trainable parameters (the optimizer's fp32 masters),
the BatchNorm running statistics, the optimizer state and {step, best_iou};
the frozen parameters are not saved and keep the values they have when a
checkpoint is restored. One file a step, `step_<step>.pt`, at most
`max_to_keep` of them.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from xmask3d_tpu_torch.engine.builder import label_tree

_FILE = re.compile(r"step_(\d+)\.pt$")


def _trainable(state):
    """{dotted name: (parameter, master)} of the trainable parameters."""
    labels = label_tree(state.model)
    params = dict(state.model.named_parameters())
    masters = {id(p): m for pairs in state.optimizer.pairs.values() for p, m in pairs}
    return {name: (params[name], masters[id(params[name])])
            for name, lab in labels.items() if lab != "frozen"}


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
        payload = {
            "trainable": {n: m.detach().cpu() for n, (_, m) in _trainable(state).items()},
            "batch_stats": {n: b.detach().cpu() for n, b in state.model.named_buffers()},
            "opt_state": state.optimizer.state_dict(),
            "meta": {"step": int(step), "best_iou": float(best_iou), **(extra or {})},
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _load(self, step: Optional[int]) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
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
        with torch.no_grad():
            for name, (p, m) in trainable.items():
                m.copy_(payload["trainable"][name])
                if m is not p:
                    p.copy_(m)
            buffers = dict(state.model.named_buffers())
            for name, value in payload["batch_stats"].items():
                buffers[name].copy_(value)
        state.optimizer.load_state_dict(payload["opt_state"])
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
