"""Training step: loss weighting, two-group AdamW over fp32 masters.

Counterpart of `xmask3d_tpu/engine/train_step.py`. The model keeps its
parameters in the compute dtype, as serving does; the optimizer keeps an
fp32 master of every trainable parameter (the parameter itself when it is
fp32), casts the gradients to fp32, runs AdamW on the masters and copies
them back. That is the JAX package's fp32 parameters and optax state with
the cast at use. Each step sets both groups' learning rates from the
schedule at the step count before the update, as optax evaluates it; the
frozen group has no gradients and no optimizer state.

Under a process group each rank's losses are its share of the global
batch's (`losses/criterion.py`), so the masters' fp32 gradients are summed
over the data axis's ranks (one bucketed all-reduce) before the gradient
norms and the update, which then see the global gradient on every rank, as
under the JAX package's data mesh. The step's point draws are made for the
global batch from the generator every rank shares, and each rank takes its
rows. Under a model axis (`parallel/tensor.py`) a sharded parameter's
master and its AdamW moments are the rank's slice, its gradient the
slice's; the gradient norms add the model group's sums of squares of the
sharded masters, so each is the norm of the whole gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from xmask3d_tpu_torch.engine.builder import label_tree
from xmask3d_tpu_torch.ops.point_sample import point_draws
from xmask3d_tpu_torch.parallel.mesh import (
    all_reduce_sum_, current_mesh, data_size, model_size, rows_of_rank)
from xmask3d_tpu_torch.parallel.tensor import sharded_tensors
from xmask3d_tpu_torch.utils.lr_schedule import cosine_lr, poly_lr
from xmask3d_tpu_torch.utils.spans import span

GROUPS = ("3d", "others")


class MasterAdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) over fp32 masters of a model's
    trainable parameters, one group per label with its own schedule."""

    def __init__(self, model: nn.Module, base_lrs: Dict[str, float],
                 schedules: Dict[str, Callable[[int], float]], weight_decay: float = 0.01):
        labels = label_tree(model)
        shards = sharded_tensors(model)
        self.pairs: Dict[str, List[Tuple[nn.Parameter, torch.Tensor]]] = {g: [] for g in GROUPS}
        self.sharded = set()  # ids of the masters of sharded parameters
        for name, p in model.named_parameters():
            if labels[name] == "frozen":
                continue
            master = p if p.dtype == torch.float32 else p.detach().float().requires_grad_()
            self.pairs[labels[name]].append((p, master))
            if name in shards:
                self.sharded.add(id(master))
        self.schedules = [schedules[g] for g in GROUPS]
        self._reduced = False
        self.adamw = torch.optim.AdamW(
            [{"params": [m for _, m in self.pairs[g]], "lr": base_lrs[g]} for g in GROUPS],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def reduce_gradients(self) -> None:
        """Give every master its parameter's gradient in fp32 (zero where
        the parameter has none) and, under a process group, sum the masters'
        gradients over the ranks in one fp32 all-reduce. Runs once a step:
        `grad_norms` and `step` call it; the parameters keep their own
        gradients until `step`."""
        if self._reduced:
            return
        grads = []
        for pairs in self.pairs.values():
            for p, m in pairs:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if m is not p:
                    m.grad = p.grad.float()
                grads.append(m.grad)
        all_reduce_sum_(grads)
        self._reduced = True

    def grad_norms(self) -> Dict[str, torch.Tensor]:
        """Each group's gradient norm (fp32), before `step`: the global
        gradient's under a process group, the whole (unsharded) gradient's
        under a model axis."""
        self.reduce_gradients()
        if model_size() == 1:
            return {g: torch.nn.utils.get_total_norm([m.grad for _, m in pairs])
                    for g, pairs in self.pairs.items()}
        device = next(m.device for pairs in self.pairs.values() for _, m in pairs)
        norms = {}
        for g, pairs in self.pairs.items():
            sq = []
            for sharded in (False, True):
                grads = [m.grad for _, m in pairs if (id(m) in self.sharded) == sharded]
                # a group without such masters (the 3d group has no sharded
                # one) adds a zero on the masters' device, where NCCL reduces
                sq.append(torch.nn.utils.get_total_norm(grads).square() if grads
                          else torch.zeros((), device=device))
            dist.all_reduce(sq[1], group=current_mesh().model_group)
            norms[g] = (sq[0] + sq[1]).sqrt()
        return norms

    def step(self, step: int) -> None:
        """One AdamW update at learning rates schedule(step) from the
        masters' gradients (`reduce_gradients`). A trainable parameter
        without a gradient takes a zero one (decay and moments still move,
        as in optax), then every gradient is released."""
        for group, sched in zip(self.adamw.param_groups, self.schedules):
            group["lr"] = sched(step)
        self.reduce_gradients()
        self.adamw.step()
        with torch.no_grad():
            for pairs in self.pairs.values():
                for p, m in pairs:
                    if m is not p:
                        p.copy_(m)
                        m.grad = None
                    p.grad = None
        self._reduced = False

    def masters(self) -> Dict[str, List[torch.Tensor]]:
        return {g: [m for _, m in pairs] for g, pairs in self.pairs.items()}

    def state_dict(self):
        return self.adamw.state_dict()

    def load_state_dict(self, state) -> None:
        self.adamw.load_state_dict(state)


def make_optimizer(model: nn.Module, lr_3d: float, lr_others: float, total_steps: int,
                   schedule: str = "cosine", power: float = 0.9,
                   weight_decay: float = 0.01) -> MasterAdamW:
    """Two-group AdamW with a per-step cosine or poly learning rate."""

    def sched(base: float) -> Callable[[int], float]:
        if schedule == "cosine":
            return lambda step: cosine_lr(base, step, total_steps)
        return lambda step: poly_lr(base, step, total_steps, power)

    return MasterAdamW(model, {"3d": lr_3d, "others": lr_others},
                       {"3d": sched(lr_3d), "others": sched(lr_others)}, weight_decay)


def weight_losses(losses: Dict[str, torch.Tensor], loss_weight: Dict[str, float],
                  class_weight: float = 2.0, mask_weight: float = 5.0, dice_weight: float = 5.0,
                  contra_on=None):
    """The weighted total: class / mask / dice weights for every layer's
    copy, the config's `loss_weight` for the rest; `contra_on` gates
    loss_3d_contra; keys with no weight (the `metric_*` histograms) are
    left out."""
    total = 0.0
    for k, v in losses.items():
        if k.startswith("loss_ce"):
            w = class_weight
        elif k.startswith("loss_mask"):
            w = mask_weight
        elif k.startswith("loss_dice"):
            w = dice_weight
        elif k in loss_weight:
            w = loss_weight[k]
        else:
            continue
        v = v * w
        if k == "loss_3d_contra" and contra_on is not None:
            v = v * contra_on
        total = total + v
    return total


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: MasterAdamW
    step: int
    generator: torch.Generator  # the point draws of every step


def create_train_state(model: nn.Module, optimizer: MasterAdamW, seed: int = 0) -> TrainState:
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, step=0, generator=gen)


def make_train_step(loss_weight: Dict[str, float]):
    """train_step(state, batch, statics, contra_on, draws=None) -> metrics:
    forward with the step's point draws (made from the state's generator
    unless given: this rank's rows of the global batch's), weighted total,
    backward, AdamW update; advances `state.step`. Metrics are detached
    device tensors: `loss_total`, every loss term and the IoU histograms
    (of the global batch: summed over the ranks), and `grad_norm_<group>`.
    The step's stages are `utils/spans.py` spans (`xm3d.train.*`), seen
    under a profiler."""

    def train_step(state: TrainState, batch, statics, contra_on: float,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        with span("xm3d.train.step"):
            model, c = state.model, state.model.cfg
            if draws is None:
                b, t = batch["target_labels"].shape
                with span("xm3d.train.draws"):
                    draws = rows_of_rank(point_draws(
                        state.generator, c.dec_layers + 1, b * data_size(), t, c.num_points,
                        c.oversample_ratio, c.importance_sample_ratio,
                        device=batch["img"].device), dim=1)
            with span("xm3d.train.forward"):
                losses, _ = model(batch, statics, train=True, draws=draws)
                total = weight_losses(losses, loss_weight, c.class_weight, c.mask_weight,
                                      c.dice_weight, contra_on=contra_on)
            with span("xm3d.train.backward"):
                total.backward()
            with span("xm3d.train.optimizer"):
                norms = state.optimizer.grad_norms()
                state.optimizer.step(state.step)
                state.step += 1
            with span("xm3d.train.metrics"):
                metrics = {"loss_total": total.detach()}
                metrics.update({k: v.detach() for k, v in losses.items()})
                # every rank's share of the losses and histograms, added up
                all_reduce_sum_(list(metrics.values()))
                metrics.update({f"grad_norm_{g}": n for g, n in norms.items()})
            return metrics

    return train_step
