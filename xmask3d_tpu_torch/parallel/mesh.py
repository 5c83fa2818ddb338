"""The process mesh: the counterpart of `xmask3d_tpu/parallel/mesh.py`'s
`data` axis here, and of its `model` axis through `parallel/tensor.py`.

Under the JAX package's data mesh, pjit splits a global batch's leading axis
over the devices, sums every gradient, takes BatchNorm statistics over the
global batch (`psum` in `MaskedBatchNorm`) and normalises every loss by a
global count. The port runs one process a device (`torchrun`), each with a
full copy of the model, and keeps the same math: `batch_size` is the global
batch and rank r takes rows [r b / w, (r + 1) b / w) of it
(`rows_of_rank`); a loss's denominator is its sum over the ranks
(`global_sum`), so each rank's loss is its own numerator over the global
count and the ranks' gradients add up to the one-process gradient
(`all_reduce_sum_`, in fp32); BatchNorm adds its moments over the ranks
with a reduction that carries gradients (`all_reduce_with_grad`); eval
takes scene i on rank i % w (`scenes_of_rank`) and adds the IoU meters
(`all_reduce_acc`). Without a process group every function is the
identity, and nothing is communicated.

`create_mesh(data, model)` lays the world out as the JAX module's
`reshape(data, model)`: rank = data_rank * model + model_rank, so the ranks
of one model group are consecutive. Once a mesh is made, the functions
above work over its data group: the ranks of one model group hold the same
rows, so a sum over the world would count them `model` times. The model
group is what `parallel/tensor.py`'s layers reduce over, and what
`parallel/spatial.py` splits the SD towers' maps over by rows
(`activation_sharding`, `shard_spatial`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from xmask3d_tpu_torch.device import resolve_device


def init_distributed(device=None, init_method: str = "env://",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group that `RANK` / `WORLD_SIZE` / `LOCAL_RANK`
    describe (torchrun sets them, with `MASTER_ADDR` / `MASTER_PORT` for the
    default `env://` rendezvous) and return this process's device. With
    none of them set the world is one process and no group is made.

    The device is `cuda:LOCAL_RANK` (made the current device, so that
    `resolve_device(None)` gives it), reduced over NCCL; CPU tensors and
    gloo only when `device="cpu"` is asked. `backend="gloo"` runs CUDA
    tensors over gloo: NCCL refuses two ranks on one card. Without CUDA and
    without `device="cpu"` it raises."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None and torch.cuda.is_available():
        torch.cuda.set_device(local)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        torch.cuda.set_device(dev)
    if not any(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return dev
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init_method,
            rank=int(os.environ.get("RANK", "0")),
            world_size=int(os.environ.get("WORLD_SIZE", "1")))
    return dev


def distributed() -> bool:
    """Whether a process group is set up (even one of one process)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) layout of the world and this rank's place in it.
    `data_group` is None for the whole world (a mesh without a model axis,
    which then communicates as no mesh does); `model_group` is None when
    the model axis is 1."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


_MESH: Optional[Mesh] = None


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """Lay the world out as a (data, model) mesh and make it the current
    one. data=-1 takes all remaining ranks. Raises where the JAX
    `create_mesh` asserts: when `model` does not divide the world, or when
    data * model is not the world size. Every rank must call it (it makes
    the groups, each on every rank, in one order)."""
    global _MESH
    n = world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    dr, mr = divmod(rank(), model)
    data_group = model_group = None
    if model > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == mr:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == dr:
                model_group = g
    _MESH = Mesh(data, model, dr, mr, data_group, model_group)
    return _MESH


def current_mesh() -> Optional[Mesh]:
    return _MESH


def model_size() -> int:
    """The current mesh's model axis; 1 without a mesh."""
    return _MESH.model if _MESH is not None else 1


def model_rank() -> int:
    return rank() % model_size()


def data_size() -> int:
    """Ranks that split a batch: the world over the model axis."""
    return world_size() // model_size()


def data_rank() -> int:
    return rank() // model_size()


def _data_reduce(t: torch.Tensor) -> None:
    """Sum t in place over the data group: the world without a model axis;
    nothing when the data axis is 1."""
    if model_size() == 1:
        dist.all_reduce(t)
    elif data_size() > 1:
        dist.all_reduce(t, group=_MESH.data_group)


def rows_of_rank(x, dim: int = 0):
    """This rank's equal share of `x` along `dim`: rows [r n / w, (r + 1) n
    / w) of a tensor or a list (of samples); a dict, tuple or dataclass (a
    batch with its `SparseHierarchy`) has each of its leaves cut so, and
    None stays None. Raises if w does not divide n."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: rows_of_rank(v, dim) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(rows_of_rank(v, dim) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: rows_of_rank(getattr(x, f.name), dim)
                                         for f in dataclasses.fields(x)})
    w, r = data_size(), data_rank()
    n = x.shape[dim] if torch.is_tensor(x) else len(x)
    if n % w:
        raise ValueError(f"a batch of {n} rows does not split over {w} ranks")
    per = n // w
    if torch.is_tensor(x):
        return x.narrow(dim, r * per, per)
    return x[r * per:(r + 1) * per]


def scenes_of_rank(n: int) -> List[int]:
    """The scene indices of this rank: i % w == r, as the JAX CLI shards
    (w and r of the data axis)."""
    w, r = data_size(), data_rank()
    return [i for i in range(n) if i % w == r]


def _comm_device() -> torch.device:
    """Where a host value goes to be reduced: the current CUDA device under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, detached: a loss's global denominator."""
    x = x.detach()
    if not distributed():
        return x
    y = x.clone()
    _data_reduce(y)
    return y


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        _data_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _data_reduce(g)
        return g


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiable: the backward sums the
    ranks' gradients of the result, so each rank's input gets the gradient
    of the global objective. x itself without a group."""
    return _AllReduceSum.apply(x) if distributed() else x


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum tensors over the ranks in place, one bucket a dtype: one
    all-reduce of the concatenation of each dtype's tensors, so each sum
    is taken in its tensors' own type. Nothing without a group."""
    if not distributed():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _data_reduce(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_reduce_acc(acc):
    """IoU meters summed over the ranks as int64, exactly (the JAX CLI's
    `all_reduce_acc` sends int32): `acc` is a dict of dicts or tuples of
    integer-valued numpy counts, returned in the same layout and dtypes.
    The meters themselves without a group."""
    if not distributed():
        return acc
    leaves = [np.asarray(v) for inner in acc.values()
              for v in (inner.values() if isinstance(inner, dict) else inner)]
    if any(not np.array_equal(v, np.round(v)) for v in leaves):
        raise ValueError("an IoU meter holds a count that is not an integer")
    flat = torch.from_numpy(np.concatenate([v.reshape(-1) for v in leaves]).astype(np.int64))
    flat = flat.to(_comm_device())
    _data_reduce(flat)
    flat = flat.cpu().numpy()
    sums, off = [], 0
    for v in leaves:
        sums.append(flat[off:off + v.size].reshape(v.shape).astype(v.dtype))
        off += v.size
    it = iter(sums)
    return {s: ({k: next(it) for k in inner} if isinstance(inner, dict)
                else tuple(next(it) for _ in inner)) for s, inner in acc.items()}


def broadcast_module(module: torch.nn.Module) -> None:
    """Give every rank rank 0's parameters and buffers, then check once that
    they are equal everywhere (each tensor's float64 sum against rank 0's,
    bit for bit). Nothing without a group."""
    if not distributed():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
        sums = torch.stack([t.detach().double().sum() for t in tensors])
        ref = sums.clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(sums, ref):
            raise RuntimeError(f"rank {rank()}: the weights differ from rank 0's after the "
                               "broadcast")


def shard_batch_by_host(global_index: np.ndarray) -> np.ndarray:
    """This rank's slice of a global sample index, [data_rank::data] (the
    JAX module's, over processes)."""
    return global_index[data_rank()::data_size()]
