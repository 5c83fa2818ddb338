"""The training step, plain: the loss weighting, the parameter groups and
two-group AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01) with a
per-step cosine learning rate, on fp32 parameters. The SD towers, their
text encoder, the shared noise and CLIP are frozen: no gradient is taken
for them, while gradients flow through their activations. A trainable
parameter without a gradient takes a zero one (decay and moments still
move)."""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from benchmark.reference.ops.point_sample import point_draws
from benchmark.reference.utils.lr_schedule import cosine_lr, poly_lr

FROZEN_MARKERS = ("ldm_extractor/vae", "ldm_extractor/unet", "ldm_extractor/text_encoder",
                  "ldm_extractor/shared_noise", "clip/")
GROUPS = ("3d", "others")


def param_label(name: str) -> str:
    """"3d" (the 3D UNets), "frozen" or "others", from a dotted name."""
    path = name.replace(".", "/")
    if "pc_decoder" in path or "pc_binary_head" in path:
        return "3d"
    if any(m in path for m in FROZEN_MARKERS) or path.startswith("clip"):
        return "frozen"
    return "others"


def weight_losses(losses: Dict[str, torch.Tensor], loss_weight: Dict[str, float],
                  class_weight: float = 2.0, mask_weight: float = 5.0, dice_weight: float = 5.0,
                  contra_on=None):
    """The weighted total: class / mask / dice weights for every layer's
    copy, `loss_weight` for the rest, `contra_on` gating loss_3d_contra;
    the `metric_*` histograms are left out."""
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


class Trainer:
    """The reference's training state: the model in train mode with its
    frozen group excluded from autograd, AdamW over the two groups, and the
    generator of the steps' point draws."""

    def __init__(self, model: nn.Module, lr_3d: float, lr_others: float, total_steps: int,
                 schedule: str, seed: int, loss_weight: Dict[str, float]):
        self.model = model.train()
        self.named: Dict[str, List] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            g = param_label(name)
            p.requires_grad_(g != "frozen")
            if g != "frozen":
                self.named[g].append((name, p))
        base = {"3d": lr_3d, "others": lr_others}

        def sched(b):
            if schedule == "cosine":
                return lambda step: cosine_lr(b, step, total_steps)
            return lambda step: poly_lr(b, step, total_steps, 0.9)

        self.schedules = [sched(base[g]) for g in GROUPS]
        self.adamw = torch.optim.AdamW(
            [{"params": [p for _, p in self.named[g]], "lr": base[g]} for g in GROUPS],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
        self.gen = torch.Generator(device=next(model.parameters()).device)
        self.gen.manual_seed(int(seed))
        self.loss_weight = loss_weight
        self.step_count = 0

    def trainables(self):
        return [(n, p) for g in GROUPS for n, p in self.named[g]]

    def forward_backward(self, batch, statics, contra_on: float):
        """Losses and the weighted total of one batch, its gradients in
        `.grad`."""
        c = self.model.cfg
        b, t = batch["target_labels"].shape
        draws = point_draws(self.gen, c.dec_layers + 1, b, t, c.num_points, c.oversample_ratio,
                            c.importance_sample_ratio, device=batch["img"].device)
        losses, _ = self.model(batch, statics, train=True, draws=draws)
        total = weight_losses(losses, self.loss_weight, c.class_weight, c.mask_weight,
                              c.dice_weight, contra_on=contra_on)
        total.backward()
        return total.detach(), losses

    def update(self) -> None:
        for group, sched in zip(self.adamw.param_groups, self.schedules):
            group["lr"] = sched(self.step_count)
        for _, p in self.trainables():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.step_count += 1
