"""How far the training gradient moves under a tiny nudge of the weights.

The tiny model's weighted training loss is taken back twice on the same
batch and point draws: once as built, once with every parameter scaled by
(1 + nudge * N(0, 1)). A smooth gradient would move by about `nudge`; the
model's moves by far more where a bilinear sample crosses a pixel centre or
a ReLU input crosses zero. That spread is the floor of any leaf-by-leaf
comparison of two frameworks whose fp32 forwards differ by ~1e-6.

    python -m xmask3d_tpu_torch.tools.grad_sensitivity --device cpu --image 64

Prints, per leaf, the largest change over the leaf's largest value and the
relative L2 change, worst first, then one JSON line with the worst of each.
Leaves whose gradient is zero in exact arithmetic (the attention key
biases) are left out.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine.builder import build_statics, build_train_model
from xmask3d_tpu_torch.engine.train_step import weight_losses
from xmask3d_tpu_torch.ops.point_sample import point_draws

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..", "configs", "scannet",
                      "xmask3d_scannet_B15N4.yaml")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda unless cpu is asked for")
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--nudge", type=float, default=1e-6)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = load_config(CONFIG)
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32", dec_layers=2, pixel_enc_layers=2)
    model = build_train_model(cfg, tiny=True, device=args.device)
    dev = next(model.parameters()).device
    statics = build_statics(model, cfg, device=dev)
    batch = synthetic_batch(2, Capacities(512, 256, 8), seed=0, num_points=400,
                            image_size=(args.image, args.image), mask_shape=(24, 32),
                            context_length=16, vocab_size=512, device=dev)
    batch["binary_label_3d"][0] = 0.0  # one all-novel and one all-base view: contra is live
    batch["binary_label_3d"][1] = 1.0
    draws = point_draws(torch.Generator(device=dev).manual_seed(0), model.cfg.dec_layers + 1,
                        2, 8, model.cfg.num_points, device=dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def grads():
        model.load_state_dict(start)  # the step moved the BatchNorm statistics
        model.zero_grad(set_to_none=True)
        losses, _ = model(batch, statics, train=True, draws=draws)
        weight_losses(losses, dict(cfg.loss_weight), contra_on=1.0).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    base = grads()
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for k, v in start.items():
            if v.is_floating_point() and k in dict(model.named_parameters()):
                start[k] = v * (1 + args.nudge * torch.randn(v.shape, generator=gen, device=dev))
    moved = grads()
    rows = []
    for n, g in base.items():
        if n.endswith("k_proj.bias"):
            continue
        d = moved[n] - g
        rows.append((float(d.abs().max() / g.abs().max().clamp(min=1e-30)),
                     float(d.norm() / g.norm().clamp(min=1e-30)), n))
    rows.sort(reverse=True)
    for mx, l2, n in rows[:args.top]:
        print(f"{mx:.4g} {l2:.4g} {n}")
    out = {"device": str(dev), "image": args.image, "nudge": args.nudge, "leaves": len(rows),
           "worst_max": rows[0][0], "worst_max_leaf": rows[0][2],
           "worst_l2": max(r[1] for r in rows)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
