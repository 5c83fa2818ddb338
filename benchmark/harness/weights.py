"""The benchmark's weights: every parameter and buffer of the model, made on
the card from the seed in one draw, in the type they are served in (bf16
parameters, fp32 BatchNorm statistics). The port and the reference load the
same values.

The rules follow the parameter names of the reference's module tree
(the port's names are the same, and a port that renames a leaf fails to
load): norm scales 1 and biases 0; the sampling-offset biases their
directional grid; dense weights N(0, 1/fan_in); sparse kernels N(0,
2/fan_in), for the ReLU nets; the shared noise N(0, 1); every other leaf
(embeddings, queries, the conditioning gates) N(0, 0.02); the two logit
scales log(1/0.07); BatchNorm statistics mean 0 and variance 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.reference.models.layers import GroupNorm
from benchmark.reference.models.pixel_decoder import MSDeformAttnLayer, _offsets_init

LOGIT_SCALE = math.log(1 / 0.07)


def _fan_in(shape) -> int:
    """Contraction size: Linear (out, in), conv OIHW, sparse (K, C_in, C_out)."""
    if len(shape) == 2:
        return shape[1]
    if len(shape) == 4:
        return shape[1] * shape[2] * shape[3]
    return shape[0] * shape[1]


def specs(model: nn.Module) -> List[Tuple[str, Tuple[int, ...], str, object]]:
    """(state-dict name, shape, rule, argument) of every leaf, in state-dict
    order; `model` may live on the meta device."""
    owner = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            owner[f"{mod_name}.{leaf}" if mod_name else leaf] = (mod_name, mod, leaf)
    parents = dict(model.named_modules())
    out = []
    for name, t in model.state_dict(keep_vars=True).items():
        mod_name, mod, leaf = owner[name]
        shape = tuple(t.shape)
        if not isinstance(t, nn.Parameter):
            if leaf not in ("mean", "var"):
                raise ValueError(f"no rule for the buffer {name}")
            out.append((name, shape, "fill", 0.0 if leaf == "mean" else 1.0))
        elif len(shape) == 0:
            out.append((name, shape, "fill", LOGIT_SCALE))
        elif leaf == "scale" or (leaf == "weight" and isinstance(mod, (nn.LayerNorm, GroupNorm))):
            out.append((name, shape, "fill", 1.0))
        elif leaf == "bias" and mod_name.endswith("sampling_offsets"):
            layer = parents[mod_name.rsplit(".", 1)[0]]
            if not isinstance(layer, MSDeformAttnLayer):
                raise ValueError(f"no rule for {name}")
            out.append((name, shape, "grid", (layer.heads, layer.levels, layer.points)))
        elif leaf == "bias":
            out.append((name, shape, "fill", 0.0))
        elif leaf == "shared_noise":
            out.append((name, shape, "normal", 1.0))
        elif leaf == "weight" and len(shape) >= 2:
            out.append((name, shape, "normal", 1.0 / math.sqrt(_fan_in(shape))))
        elif leaf == "kernel":
            out.append((name, shape, "normal", math.sqrt(2.0 / _fan_in(shape))))
        else:
            out.append((name, shape, "normal", 0.02))
    return out


@torch.no_grad()
def make_weights(leaves, seed: int, device, param_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} on `device`: every normal leaf a slice of one draw of
    N(0, 1) in `param_dtype` from a card generator seeded with `seed`,
    scaled by its std; BatchNorm statistics in fp32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(s) for _, s, rule, _ in leaves if rule == "normal")
    flat = torch.randn(total, generator=gen, device=device, dtype=param_dtype)
    out, off = {}, 0
    for name, shape, rule, arg in leaves:
        n = math.prod(shape)
        stat = name.endswith(".mean") or name.endswith(".var")
        dtype = torch.float32 if stat else param_dtype
        if rule == "normal":
            out[name] = flat[off:off + n].view(shape).mul_(arg)
            off += n
        elif rule == "fill":
            out[name] = torch.full(shape, arg, dtype=dtype, device=device)
        else:
            grid = torch.from_numpy(_offsets_init(*arg).reshape(-1))
            out[name] = grid.to(device=device, dtype=dtype).view(shape)
    return out
