"""Data parallelism across processes: the counterpart of the `data` axis of
`xmask3d_tpu/parallel/mesh.py`.

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

Tensor and activation parallelism (the JAX module's `model` axis) are not
here (ROADMAP A 6).
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
    w, r = world_size(), rank()
    n = x.shape[dim] if torch.is_tensor(x) else len(x)
    if n % w:
        raise ValueError(f"a batch of {n} rows does not split over {w} ranks")
    per = n // w
    if torch.is_tensor(x):
        return x.narrow(dim, r * per, per)
    return x[r * per:(r + 1) * per]


def scenes_of_rank(n: int) -> List[int]:
    """The scene indices of this rank: i % w == r, as the JAX CLI shards."""
    w, r = world_size(), rank()
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
    dist.all_reduce(y)
    return y


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
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
        dist.all_reduce(flat)
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
    dist.all_reduce(flat)
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
