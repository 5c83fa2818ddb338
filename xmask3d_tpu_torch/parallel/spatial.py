"""Activation sharding: the SD UNet's and VAE's maps as row bands over the
mesh's model group. The counterpart of `activation_sharding` and
`shard_spatial` in `xmask3d_tpu/parallel/mesh.py` (:104-147).

The JAX package constrains dim 1 (the rows of an NHWC map) of every SD UNet
and VAE block output to shard over the `model` axis; XLA's partitioner then
splits each conv by rows with halo exchanges, attention by query rows, and
merges the GroupNorm reductions. The port has no partitioner, so the towers
run their bands and make every exchange themselves, over the model group of
the mesh given to `activation_sharding` (`parallel/mesh.py` `create_mesh`):
rank r of m holds rows [r H / m, (r + 1) H / m) of every map.

- A tower decides once, at its entry (`banded`), from its input's rows:
  it runs in bands where every level's rows split evenly into m and each
  stride-2 conv sees an even band, and replicated otherwise (the JAX no-op,
  taken per tower). Every rank decides the same way.
- In a band a 3x3 conv reads its neighbours' edge rows (`halo`), a
  GroupNorm sums its moments over the group (`all_reduce_band`),
  self-attention gathers its keys and values (`gather_rows`) and runs
  kernel K2 on the band's queries, and kernel K4 merges the bands'
  statistics and convolves the band with raw halo rows. 1x1 convs,
  upsampling and the per-token layers stay local. The tower gathers its
  outputs at its exit (`gather_spatial`).
- Under tensor parallelism as well (`parallel/tensor.py`), a column-parallel
  layer reads all rows (`reads_all_rows`: gathered, the backward a
  reduce-scatter) and a row-parallel one reduce-scatters its sums to the
  band: Megatron's sequence parallelism (Korthikanti et al. 2022, "Reducing
  Activation Recomputation in Large Transformer Models").

Gradients. A replicated input that every band reads (the latent or image,
`context`, `cond_emb`) passes `copy_to_band`, whose backward sums the bands'
gradients, so each rank ends with the whole gradient, as without bands. A
parameter of a banded tower gets its band's share on each rank;
`reduce_band_grads` sums them (the slices of `shard_params` are whole).

Collectives, all over the model group. Gloo takes CUDA tensors in
`all_gather` and `all_reduce` only, so there a reduce-scatter is an
all-reduce and the rank's rows, and an all-to-all an all-gather and the
rank's part (the same numbers); NCCL and gloo on the CPU run
`reduce_scatter_tensor` and `all_to_all_single`. A halo is one all-gather
of every rank's edge rows under every backend. Every rank issues the same
collectives in the same order, in the forward, the backward and a remat
block's recompute (`RematBlock` restores the band it ran in).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from xmask3d_tpu_torch.parallel.mesh import Mesh

_MESH: Optional[Mesh] = None   # the mesh `activation_sharding` installed
_BAND: Optional[Mesh] = None   # its mesh while a tower runs in bands


@contextlib.contextmanager
def activation_sharding(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the SD UNet and VAE towers in row bands over `mesh`'s model
    group inside the block. A mesh of None, or one whose model axis is 1,
    makes it a no-op (callers can thread one flag through)."""
    global _MESH
    prev = _MESH
    _MESH = mesh if mesh is not None and mesh.model > 1 else None
    try:
        yield
    finally:
        _MESH = prev


def sharding_mesh() -> Optional[Mesh]:
    """The mesh of `activation_sharding`, or None when it is off."""
    return _MESH


def current_band() -> Optional[Mesh]:
    """The mesh of the tower now running in bands, or None."""
    return _BAND


@contextlib.contextmanager
def use_band(band: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Run the block with `band` (a mesh, or None) as the current band."""
    global _BAND
    prev = _BAND
    _BAND = band
    try:
        yield band
    finally:
        _BAND = prev


def band_fits(h: int, halvings: int, m: int) -> bool:
    """Whether a tower whose input has h rows and which halves them
    `halvings` times by stride-2 convs runs in m bands: the last level's
    rows split evenly into m (then every stride-2 conv sees an even band)."""
    unit = m * 2 ** halvings
    return h >= unit and h % unit == 0


@contextlib.contextmanager
def banded(h: int, halvings: int = 0) -> Iterator[Optional[Mesh]]:
    """A tower's entry: inside the block the tower runs in bands (yields
    the mesh) where sharding is on and `band_fits`, else replicated (yields
    None)."""
    mesh = _MESH
    with use_band(mesh if mesh is not None and band_fits(h, halvings, mesh.model)
                  else None) as band:
        yield band


# ---------------------------------------------------------------------------
# collectives over a mesh's model group
# ---------------------------------------------------------------------------


def _gloo_cuda(t: torch.Tensor, mesh: Mesh) -> bool:
    return t.is_cuda and dist.get_backend(mesh.model_group) == "gloo"


def _gather_parts(x: torch.Tensor, mesh: Mesh):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x, group=mesh.model_group)
    return parts


def _all_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return torch.cat(_gather_parts(x, mesh), dim=dim)


def _own(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * n, n).contiguous()


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.model_group)
    return y


def _reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The rank's part along `dim` of x summed over the group."""
    if _gloo_cuda(x, mesh):
        return _own(_all_reduce(x, mesh), dim, mesh)
    parts = x.movedim(dim, 0).contiguous()
    out = parts.new_empty((parts.shape[0] // mesh.model, *parts.shape[1:]))
    dist.reduce_scatter_tensor(out, parts, group=mesh.model_group)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, mesh: Mesh) -> torch.Tensor:
    """x cut into m parts along `split_dim`, part q sent to rank q; the
    parts received concatenated along `cat_dim` in rank order."""
    if _gloo_cuda(x, mesh):
        return _own(_all_gather(x, cat_dim, mesh), split_dim, mesh)
    parts = torch.stack(x.chunk(mesh.model, dim=split_dim))
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=mesh.model_group)
    return torch.cat(out.unbind(0), dim=cat_dim)


# autograd Functions over a mesh's model group, named by their forward; each
# one's backward is what the use of its result calls for (also the
# column- and row-parallel layers' of `parallel/tensor.py`)


class AllGather(torch.autograd.Function):
    """All-gather along `dim`; the backward takes the rank's part (what
    reads the gathered tensor is replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.mesh), None, None


class AllGatherSum(torch.autograd.Function):
    """All-gather along `dim`; the backward is the rank's part of the summed
    gradient (every rank's use of the gathered tensor is a share)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.mesh), None, None


class OwnPart(torch.autograd.Function):
    """The rank's part along `dim` of a replicated tensor; the backward
    all-gathers."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mesh), None, None


class ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along `dim`; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _reduce_scatter(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mesh), None, None


class CopyToGroup(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group (Megatron's
    `f`)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class AllReduce(torch.autograd.Function):
    """Sum over the group; the backward sums the gradient over it too (each
    rank's result feeds that rank's share of the objective)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _AllToAll(torch.autograd.Function):
    """`_all_to_all`; the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, mesh, split_dim, cat_dim):
        ctx.mesh, ctx.dims = mesh, (split_dim, cat_dim)
        return _all_to_all(x, split_dim, cat_dim, mesh)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, cat_dim, split_dim, ctx.mesh), None, None, None


class _Halo(torch.autograd.Function):
    """The band with `top` rows of the rank above and `bottom` rows of the
    rank below (one all-gather of every rank's first `bottom` and last
    `top` rows). At the map's edges: zero rows with `pad_edges`, else none.
    The backward sends each halo's gradient back to its owner, who adds it
    to its edge rows (one all-gather)."""

    @staticmethod
    def forward(ctx, x, mesh, top, bottom, pad_edges):
        m, r = mesh.model, mesh.model_rank
        h = x.shape[1]
        parts = _gather_parts(torch.cat([x[:, :bottom], x[:, h - top:]], 1), mesh)
        zeros = (lambda n: x.new_zeros((x.shape[0], n, *x.shape[2:]))) if pad_edges else None
        up = parts[r - 1][:, bottom:] if r > 0 else (zeros(top) if zeros else None)
        down = parts[r + 1][:, :bottom] if r < m - 1 else (zeros(bottom) if zeros else None)
        ctx.mesh, ctx.rows, ctx.has = mesh, (top, bottom), (up is not None, down is not None)
        return torch.cat([t for t in (up, x, down) if t is not None], 1)

    @staticmethod
    def backward(ctx, g):
        mesh, (top, bottom), (has_up, has_down) = ctx.mesh, ctx.rows, ctx.has
        m, r = mesh.model, mesh.model_rank
        t0 = top if has_up else 0
        h = g.shape[1] - t0 - (bottom if has_down else 0)
        zeros = lambda n: g.new_zeros((g.shape[0], n, *g.shape[2:]))  # noqa: E731
        g_up = g[:, :top] if has_up else zeros(top)
        g_down = g[:, t0 + h:] if has_down else zeros(bottom)
        parts = _gather_parts(torch.cat([g_up, g_down], 1), mesh)
        gx = g[:, t0:t0 + h].clone()
        if r < m - 1 and top:  # the rank below's upper halo: my last rows
            gx[:, h - top:] += parts[r + 1][:, :top]
        if r > 0 and bottom:  # the rank above's lower halo: my first rows
            gx[:, :bottom] += parts[r - 1][:, top:]
        return gx, None, None, None, None


# ---------------------------------------------------------------------------
# what the towers call
# ---------------------------------------------------------------------------


def shard_spatial(x: torch.Tensor) -> torch.Tensor:
    """The rank's band of a replicated map (B, H, ...): rows [r H / m,
    (r + 1) H / m). x itself where sharding is off, x has fewer than two
    dims, or m does not divide H (the JAX no-op). The backward all-gathers
    (each rank ends with the whole gradient)."""
    mesh = _MESH
    if mesh is None or x.ndim < 2 or x.shape[1] % mesh.model or x.shape[1] < mesh.model:
        return x
    return OwnPart.apply(x, mesh, 1)


def gather_spatial(band: torch.Tensor) -> torch.Tensor:
    """The inverse of `shard_spatial`: every rank's band concatenated along
    the rows, in rank order (identity where sharding is off). The backward
    takes the rank's rows: what reads the whole map is replicated."""
    mesh = _MESH
    return band if mesh is None else AllGather.apply(band, mesh, 1)


def gather_outputs(out):
    """`gather_spatial` of every tensor of a tower's output (a tensor, or
    lists and tuples of them)."""
    if isinstance(out, (list, tuple)):
        return type(out)(gather_outputs(o) for o in out)
    return gather_spatial(out)


def gather_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every rank's part of x along `dim` (a band's rows or tokens, or its
    moments), where a band runs; the backward is the rank's part of the
    gradient summed over the group. x itself outside a band."""
    return x if _BAND is None else AllGatherSum.apply(x, _BAND, dim)


def scatter_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The rank's rows of x summed over the group (the backward
    all-gathers); x itself outside a band."""
    return x if _BAND is None else ReduceScatter.apply(x, _BAND, dim)


def all_to_all_rows(x: torch.Tensor, rows_dim: int = 1, feat_dim: int = -1) -> torch.Tensor:
    """(all rows, the rank's features) -> (the rank's rows, all features),
    features in rank order; x itself outside a band."""
    return x if _BAND is None else _AllToAll.apply(x, _BAND, rows_dim, feat_dim)


def copy_to_band(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor that every band reads: the identity, whose
    backward sums the bands' gradients. x itself outside a band."""
    return x if _BAND is None else CopyToGroup.apply(x, _BAND)


def all_reduce_band(x: torch.Tensor) -> torch.Tensor:
    """x summed over the group, with gradient; x itself outside a band."""
    return x if _BAND is None else AllReduce.apply(x, _BAND)


def halo(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """The band (B, rows, W, C) with `top` rows from the rank above and
    `bottom` from the rank below, zeros beyond the map's edges (a conv's
    zero padding)."""
    if not (top or bottom):
        return x
    return _Halo.apply(x, _BAND, top, bottom, True)


def raw_halo(x: torch.Tensor, rows: int) -> Tuple[torch.Tensor, int, int]:
    """The band with `rows` rows of each neighbour and nothing beyond the
    map's edges, and how many rows it gained above and below: a conv that
    zero-pads what it normalises (kernel K4) is then right at the edges."""
    band = _BAND
    ext = _Halo.apply(x, band, rows, rows, False)
    return ext, rows if band.model_rank > 0 else 0, rows if band.model_rank < band.model - 1 else 0


def band_rows(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """The rank's band of a replicated map with `top` rows above and
    `bottom` below, taken locally, zeros beyond the map's edges; its
    backward sums the ranks' gradients (`copy_to_band`)."""
    band = _BAND
    x = CopyToGroup.apply(x, band)
    h = x.shape[1]
    rows = h // band.model
    lo, hi = band.model_rank * rows - top, (band.model_rank + 1) * rows + bottom
    y = x[:, max(lo, 0):min(hi, h)]
    pad = (max(0, -lo), max(0, hi - h))
    return F.pad(y, (0, 0) * (x.ndim - 2) + pad) if any(pad) else y


def reads_all_rows(layer) -> bool:
    """Whether `layer` is a model-parallel layer (`parallel/tensor.py`)
    running in a band: a column-parallel group then reads all rows
    (gathered before it)."""
    return _BAND is not None and getattr(layer, "mesh", None) is not None


def reduce_band_grads(module: torch.nn.Module, mesh: Optional[Mesh] = None) -> int:
    """Sum over the model group the gradient of every parameter of `module`,
    a banded tower (the SD UNet, the VAE's encoder or decoder), that has
    one, but the slices of `shard_params` (whole already): there each rank
    holds its band's share. What reads a tower's gathered outputs (the
    VAE's `quant_conv`) is replicated, and whole on each rank. `mesh` is
    `activation_sharding`'s unless given; nothing without one. Returns how
    many gradients were summed."""
    mesh = mesh or _MESH
    if mesh is None or mesh.model == 1:
        return 0
    sliced = {id(getattr(mod, name)) for mod in module.modules()
              if hasattr(mod, "shard_dims") for name in mod.shard_dims()}
    grads = [p.grad for p in module.parameters()
             if p.grad is not None and id(p) not in sliced]
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.model_group)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    return len(grads)
