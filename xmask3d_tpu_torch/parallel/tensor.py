"""Tensor parallelism of the dense towers: the `model` axis of
`xmask3d_tpu/parallel/mesh.py` (`param_sharding_rules`, `shard_params`).

The JAX package annotates the 2-D kernels of the SD UNet, CLIP and the
decoders with a sharding over the `model` axis and lets XLA place the
collectives. The port swaps each `nn.Linear` whose kernel the same rules
shard for one of two layers that hold only this rank's slice and make the
collectives themselves (Megatron's layout), over the mesh's model group
(`parallel/mesh.py` `create_mesh`):

- `ColumnParallelLinear` holds the rank's output features and their bias.
  Its input passes an identity whose backward sums the gradient over the
  group (Megatron's `f`). Where the next layer wants the whole output it
  ends in an all-gather whose backward takes the rank's slice.
- `RowParallelLinear` holds the rank's input features. Its partial product
  is summed over the group (forward; the backward is the identity,
  Megatron's `g`) and the bias is added once, after the sum. Where its
  input is replicated, the rank first takes its slice of it (backward: an
  all-gather).

Each layer holds the mesh it was cut for and communicates over its model
group; the models themselves know nothing of the mesh.

In a row band of `parallel/spatial.py` (`activation_sharding` on the same
model group) the layers follow Megatron's sequence parallelism (Korthikanti
et al. 2022, "Reducing Activation Recomputation in Large Transformer
Models"): the model gathers the rows before a column-parallel group
(`spatial.reads_all_rows`; the backward a reduce-scatter, which takes `f`'s
place, so a column-parallel layer makes no `f` of its own there, and one
that gathers its output sums the bands' gradients before taking its
slice); `RowParallelLinear` reduce-scatters its sums to the band (the
backward an all-gather); `GatheredLinear` takes an all-to-all, (all rows,
the rank's features) -> (the rank's rows, all features), 1/m of the
all-gather's bytes. The time embedding's projection, (B, C), has no rows.

The slices follow the heads and the packing: an attention's q/k/v take the
columns of the rank's heads (of each of q, k and v in CLIP's packed
`in_proj`), so attention (kernel K2 in the SD UNet) runs on the rank's
heads alone; GEGLU's packed [value | gate] projection takes the value and
gate columns of the same hidden units, and the replicated `ff_out` after
it becomes a `GatheredLinear` that all-gathers them. A model axis that
does not divide a sharded attention's head count raises (the JAX package
would take any axis the widths divide). Every tensor keeps its name, so the parameter groups,
the optimizer and the checkpoints see the same names as without a mesh;
`gather_params` is the inverse of `shard_params`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from xmask3d_tpu_torch.parallel import spatial
from xmask3d_tpu_torch.parallel.mesh import Mesh, current_mesh

# the JAX rule set's name keys (xmask3d_tpu/parallel/mesh.py:56-86)
SHARD_OUT = ("in_proj", "to_q", "to_k", "to_v", "mlp_c_fc", "ff_geglu", "ffn1", "linear1",
             "emb_proj")
SHARD_IN = ("out_proj", "to_out", "mlp_c_proj", "ffn2", "linear2")
# (first, second) projections of a block: column- then row-parallel
PAIRS = (("mlp_c_fc", "mlp_c_proj"), ("ffn1", "ffn2"), ("linear1", "linear2"))


def param_sharding_rules(path: Union[str, Sequence], shape: Sequence[int], mesh: Mesh
                         ) -> Optional[int]:
    """The dimension of a JAX-layout leaf that the model axis shards, or
    None (replicated): the JAX heuristic, on the path the weight bridge
    gives a tensor (`checkpoint/from_jax.py` `bridge_tensors`, a Dense
    kernel as (in, out)). 2-D kernels only: attention and MLP first
    projections shard their output features (1), second projections their
    input features (0), each only where the model axis divides the
    dimension."""
    m = mesh.model
    if m == 1:
        return None
    name = path if isinstance(path, str) else "/".join(str(p) for p in path)
    if not (name.endswith("kernel") and len(shape) == 2):
        return None
    if any(k in name for k in SHARD_OUT) and shape[1] % m == 0:
        return 1
    if any(k in name for k in SHARD_IN) and shape[0] % m == 0:
        return 0
    return None


# ---------------------------------------------------------------------------
# collectives over a mesh's model group, with their backward
# ---------------------------------------------------------------------------


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the backward is the identity (Megatron's
    `g`). The other collectives are `parallel/spatial.py`'s."""

    @staticmethod
    def forward(ctx, x, mesh):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.model_group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def take_shard(full: torch.Tensor, dim: int, packs: int, parts: int, r: int) -> torch.Tensor:
    """Rank r's slice of a full tensor along `dim`, which packs `packs`
    equal blocks (q|k|v: 3, value|gate: 2, else 1): the r-th of `parts`
    equal slices of each block, concatenated."""
    blk = full.shape[dim] // packs
    per = blk // parts
    return torch.cat([full.narrow(dim, j * blk + r * per, per) for j in range(packs)], dim=dim)


def join_shards(shards: Sequence[torch.Tensor], dim: int, packs: int) -> torch.Tensor:
    """The full tensor from every rank's slice (the inverse of
    `take_shard`)."""
    per = shards[0].shape[dim] // packs
    return torch.cat([s.narrow(dim, j * per, per) for j in range(packs) for s in shards],
                     dim=dim)


class _ParallelLinear(nn.Linear):
    """An `nn.Linear` on a mesh's model group, holding a slice of its
    weight: the slice's dimension of the weight (`dim`, 0 for output
    features and 1 for input features) and the packing of that dimension
    (`packs`)."""

    dim: int
    packs = 1

    def _init_from(self, linear: nn.Linear, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], mesh: Mesh) -> None:
        nn.Module.__init__(self)
        self.mesh = mesh
        self.in_features, self.out_features = weight.shape[1], weight.shape[0]
        self.weight = nn.Parameter(weight.detach().clone(),
                                   requires_grad=linear.weight.requires_grad)
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(bias.detach().clone(), requires_grad=linear.bias.requires_grad)

    def shard_dims(self) -> Dict[str, int]:
        """{tensor name: the dimension its slice is taken on}."""
        dims = {"weight": self.dim}
        if self.bias is not None and self.dim == 0:
            dims["bias"] = 0
        return dims


class ColumnParallelLinear(_ParallelLinear):
    """The rank's output features (`packs` blocks, each sliced) and their
    bias; `gather` concatenates the ranks' outputs (contiguous slices
    only)."""

    dim = 0

    def __init__(self, linear: nn.Linear, mesh: Mesh, packs: int = 1, gather: bool = False):
        bias = linear.bias
        self._init_from(
            linear, take_shard(linear.weight, 0, packs, mesh.model, mesh.model_rank),
            None if bias is None else take_shard(bias, 0, packs, mesh.model, mesh.model_rank),
            mesh)
        self.packs, self.gather = packs, gather

    def forward(self, x):
        if spatial.current_band() is not None:
            y = F.linear(x, self.weight, self.bias)
            return spatial.gather_rows(y, dim=-1) if self.gather else y
        y = F.linear(spatial.CopyToGroup.apply(x, self.mesh), self.weight, self.bias)
        return spatial.AllGather.apply(y, self.mesh, -1) if self.gather else y


class RowParallelLinear(_ParallelLinear):
    """The rank's input features; the partial products summed over the
    model group, then the bias. `parallel_input`: the input is already the
    rank's slice (a column-parallel layer's output, or the rank's heads);
    otherwise it is replicated and the rank takes its slice."""

    dim = 1

    def __init__(self, linear: nn.Linear, mesh: Mesh, parallel_input: bool):
        self._init_from(linear, take_shard(linear.weight, 1, 1, mesh.model, mesh.model_rank),
                        linear.bias, mesh)
        self.parallel_input = parallel_input

    def forward(self, x):
        if not self.parallel_input:
            x = spatial.OwnPart.apply(x, self.mesh, -1)
        y = F.linear(x, self.weight)
        if self.parallel_input and spatial.current_band() is not None:
            y = spatial.scatter_rows(y)
        else:
            y = _ReduceFromModel.apply(y, self.mesh)
        return y if self.bias is None else y + self.bias


class GatheredLinear(_ParallelLinear):
    """A replicated `nn.Linear` whose input is the rank's slice of its
    features (a sharded GEGLU's output): all-gathered first, the backward
    taking the rank's slice. It holds no slice (GEGLU's `ff_out`, which the
    JAX rules leave replicated)."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        self._init_from(linear, linear.weight, linear.bias, mesh)

    def shard_dims(self) -> Dict[str, int]:
        return {}

    def forward(self, x):
        if spatial.current_band() is not None:
            return F.linear(spatial.all_to_all_rows(x), self.weight, self.bias)
        return F.linear(spatial.AllGather.apply(x, self.mesh, -1), self.weight, self.bias)


# ---------------------------------------------------------------------------
# shard_params / gather_params
# ---------------------------------------------------------------------------


def _tower(mod_name: str) -> str:
    """The tower a module belongs to: its path up to the first block."""
    parts = mod_name.split(".")
    for i, p in enumerate(parts):
        if p == "transformer" or re.search(r"_\d", p):
            return ".".join(parts[:i]) or mod_name
    return mod_name


def _plan(model: nn.Module, mesh: Mesh) -> List[Tuple[nn.Module, str, object]]:
    """(module, attribute, value) to set for every Linear the rules shard,
    in module order: the parallel layers, GEGLU's gathered `ff_out` and
    the first head of each sharded CLIP attention (for the slice of its
    mask)."""
    from xmask3d_tpu_torch.models.clip import MultiHeadAttention
    from xmask3d_tpu_torch.models.sd_unet import GEGLU, CrossAttention

    def dim_of(mod_name, child_name, lin):
        path = "/".join(p for p in (mod_name.replace(".", "/"), child_name, "kernel") if p)
        return param_sharding_rules(path, (lin.in_features, lin.out_features), mesh)

    modules = dict(model.named_modules())
    plan = []
    for mod_name, mod in modules.items():
        lins = {n: c for n, c in mod.named_children()
                if isinstance(c, nn.Linear) and not isinstance(c, _ParallelLinear)}
        dims = {n: dim_of(mod_name, n, c) for n, c in lins.items()}
        if not any(d is not None for d in dims.values()):
            continue
        if isinstance(mod, (CrossAttention, MultiHeadAttention)):
            if mod.heads % mesh.model:
                raise ValueError(f"the model axis {mesh.model} does not divide the {mod.heads} "
                                 f"heads of {_tower(mod_name)} ({mod_name})")
            cols = ("to_q", "to_k", "to_v") if isinstance(mod, CrossAttention) else ("in_proj",)
            row = "to_out" if isinstance(mod, CrossAttention) else "out_proj"
            for n in cols:
                plan.append((mod, n, ColumnParallelLinear(lins[n], mesh,
                                                          packs=3 if n == "in_proj" else 1)))
            plan.append((mod, row, RowParallelLinear(lins[row], mesh, parallel_input=True)))
            if isinstance(mod, MultiHeadAttention):
                plan.append((mod, "first_head", mesh.model_rank * mod.heads // mesh.model))
            continue
        if isinstance(mod, GEGLU):
            block = modules[mod_name.rpartition(".")[0]]
            plan.append((mod, "proj", ColumnParallelLinear(lins["proj"], mesh, packs=2)))
            plan.append((block, "ff_out", GatheredLinear(block.ff_out, mesh)))
            continue
        paired = set()
        for first, second in PAIRS:
            if dims.get(first) == 1 and dims.get(second) == 0:
                plan.append((mod, first, ColumnParallelLinear(lins[first], mesh)))
                plan.append((mod, second, RowParallelLinear(lins[second], mesh,
                                                            parallel_input=True)))
                paired |= {first, second}
        for n, d in dims.items():
            if n in paired or d is None:
                continue
            plan.append((mod, n, ColumnParallelLinear(lins[n], mesh, gather=True) if d == 1
                         else RowParallelLinear(lins[n], mesh, parallel_input=False)))
    return plan


def shard_params(model: nn.Module, mesh: Optional[Mesh] = None) -> nn.Module:
    """Swap, in place, each `nn.Linear` whose kernel `param_sharding_rules`
    shards for its parallel layer holding only this rank's slice of the
    mesh's model axis (the current mesh unless one is given; the layers
    communicate over its model group). Nothing without a model axis.
    Returns the model."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.model == 1:
        return model
    plan = _plan(model, mesh)
    with torch.no_grad():
        for mod, attr, value in plan:
            setattr(mod, attr, value)
    return model


def sharded_tensors(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{dotted tensor name: (dimension, packs)} of every sharded tensor."""
    out = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, _ParallelLinear):
            for t, dim in mod.shard_dims().items():
                out[f"{mod_name}.{t}" if mod_name else t] = (dim, mod.packs)
    return out


def gather_tensor(t: torch.Tensor, dim: int, packs: int, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """The full tensor from each model rank's slice `t` (a collective of
    the model group of `mesh`, the current one unless given)."""
    mesh = mesh or current_mesh()
    t = t.detach().contiguous()
    shards = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(shards, t, group=mesh.model_group)
    return join_shards(shards, dim, packs)


def shard_tensor(full: torch.Tensor, dim: int, packs: int, mesh: Optional[Mesh] = None
                 ) -> torch.Tensor:
    """This rank's slice of a full tensor on `mesh` (the current one unless
    given)."""
    mesh = mesh or current_mesh()
    return take_shard(full, dim, packs, mesh.model, mesh.model_rank)


def gather_params(model: nn.Module) -> nn.Module:
    """The inverse of `shard_params`: each parallel layer back to an
    `nn.Linear` with the full weight and bias (a collective of each layer's
    model group). Returns the model."""
    from xmask3d_tpu_torch.models.clip import MultiHeadAttention

    swaps = [(parent, name, child) for parent in model.modules()
             for name, child in parent.named_children() if isinstance(child, _ParallelLinear)]
    with torch.no_grad():
        for parent, name, layer in swaps:
            full = {t: gather_tensor(getattr(layer, t), d, layer.packs, layer.mesh)
                    for t, d in layer.shard_dims().items()}
            w = full.get("weight", layer.weight)
            lin = nn.Linear(w.shape[1], w.shape[0], bias=layer.bias is not None,
                            device="meta")
            lin.weight = nn.Parameter(w.clone(), requires_grad=layer.weight.requires_grad)
            if layer.bias is not None:
                b = full.get("bias", layer.bias)
                lin.bias = nn.Parameter(b.clone(), requires_grad=layer.bias.requires_grad)
            setattr(parent, name, lin)
            if isinstance(parent, MultiHeadAttention):
                parent.first_head = 0
    return model
