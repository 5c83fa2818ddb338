"""Sparse 3D convolution, plain: the numpy kernel-map build and the
gather + matmul ops. A Minkowski conv is
`out[b, v] = sum_k feats[b, kmap[b, k, v]] @ W[k]` over a dense int32 gather
table `kmap` (-1 = no neighbour); transposed convs are parent gathers.

Kernel offsets enumerate with the last axis fastest; odd kernels span
-(k//2)..k//2 per axis and kernel 2 spans {0, 1}, in units of the level's
tensor stride. `sparse_conv` is differentiable in feats, weights and bias:
its backward is the plain version's VJP.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.ops.record import record


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseLevel:
    """One stride level of the voxel hierarchy (static capacity)."""

    coords: torch.Tensor  # (B, V, 3) int32, zero-padded
    valid: torch.Tensor  # (B, V) bool
    kmap3: torch.Tensor  # (B, 27, V) int32
    num: torch.Tensor  # (B,) int32


@dataclasses.dataclass
class SparseHierarchy:
    """Coordinate hierarchy + kernel maps; levels[0] is stride 1.

    down[i]: (B, 8, V_{i+1}) gather map from level i into level i+1.
    up_parent[i] / up_octant[i]: (B, V_i) parent row at level i+1 and the
    octant weight index of the transposed conv. kmap5: (B, 125, V_0)."""

    levels: Tuple[SparseLevel, ...]
    down: Tuple[torch.Tensor, ...]
    up_parent: Tuple[torch.Tensor, ...]
    up_octant: Tuple[torch.Tensor, ...]
    kmap5: torch.Tensor


@dataclasses.dataclass
class HostHierarchy:
    """One sample's hierarchy as numpy arrays (before stacking)."""

    coords: List[np.ndarray]
    valid: List[np.ndarray]
    kmap3: List[np.ndarray]
    num: List[int]
    down: List[np.ndarray]
    up_parent: List[np.ndarray]
    up_octant: List[np.ndarray]
    kmap5: np.ndarray


# ---------------------------------------------------------------------------
# Host kernel maps, exact over 20-bit-per-axis int64 keys
# ---------------------------------------------------------------------------

_BITS = 20


def _pack(coords: np.ndarray) -> np.ndarray:
    """Pack int coords (N, 3) into unique int64 keys; out-of-range
    components map to a sentinel that never aliases a real key."""
    c = coords.astype(np.int64)
    key = (c[:, 0] << (2 * _BITS)) | (c[:, 1] << _BITS) | c[:, 2]
    bad = ((c < 0) | (c >= (1 << _BITS))).any(axis=1)
    key[bad] = np.int64(1) << 62
    return key


def _offsets(kernel_size: int, stride_units: int) -> np.ndarray:
    """Kernel offsets, last axis fastest. Odd k: centered; k == 2: {0, 1}."""
    if kernel_size % 2 == 1:
        r = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    elif kernel_size == 2:
        r = np.arange(0, 2)
    else:
        raise ValueError(f"unsupported kernel_size {kernel_size}")
    mesh = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    return mesh * stride_units


def _lookup(sorted_keys: np.ndarray, order: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Map packed query keys -> original indices, -1 when absent."""
    if len(sorted_keys) == 0:
        return np.full(len(query), -1, np.int32)
    pos = np.clip(np.searchsorted(sorted_keys, query), 0, len(sorted_keys) - 1)
    hit = sorted_keys[pos] == query
    return np.where(hit, order[pos], -1).astype(np.int32)


def _build_kmap(out_coords, in_sorted_keys, in_order, offsets, capacity) -> np.ndarray:
    kmap = np.full((len(offsets), capacity), -1, dtype=np.int32)
    n_out = len(out_coords)
    for i, off in enumerate(offsets):
        if n_out:
            kmap[i, :n_out] = _lookup(
                in_sorted_keys, in_order, _pack(out_coords + off[None, :])
            )
    return kmap


def build_hierarchy(
    coords: np.ndarray,
    capacities: Sequence[int],
    num_levels: int = 5,
    stem_kernel: int = 5,
) -> HostHierarchy:
    """Full stride hierarchy + kernel maps for one voxelized sample.

    coords: (N, 3) non-negative, deduplicated voxel coords at stride 1.
    capacities: per-level static voxel capacities; voxels beyond a level's
    capacity are dropped. Sorted keys and binary search, in numpy."""
    if len(capacities) != num_levels:
        raise ValueError("one capacity per level")
    coords = np.ascontiguousarray(coords[: capacities[0]], dtype=np.int32)
    level_coords: List[np.ndarray] = [coords]
    for lv in range(1, num_levels):
        s = 2**lv
        parent = (level_coords[-1] // s) * s
        _, idx = np.unique(_pack(parent), return_index=True)
        level_coords.append(parent[np.sort(idx)][: capacities[lv]])

    sorted_keys, orders = [], []
    for c in level_coords:
        keys = _pack(c)
        order = np.argsort(keys, kind="stable").astype(np.int32)
        sorted_keys.append(keys[order])
        orders.append(order)

    def make_kmap(in_lv, out_coords, offsets, cap):
        return _build_kmap(out_coords, sorted_keys[in_lv], orders[in_lv], offsets, cap)

    def make_parent(lv, c, cap):
        s2, stride, n = 2 ** (lv + 1), 2**lv, len(c)
        pidx = _lookup(sorted_keys[lv + 1], orders[lv + 1], _pack((c // s2) * s2))
        oct3 = (c // stride) % 2
        pp = np.full((cap,), -1, dtype=np.int32)
        oo = np.zeros((cap,), dtype=np.int32)
        pp[:n] = pidx
        oo[:n] = (oct3[:, 0] * 4 + oct3[:, 1] * 2 + oct3[:, 2]).astype(np.int32)
        return pp, oo

    out = HostHierarchy([], [], [], [], [], [], [], None)
    for lv, c in enumerate(level_coords):
        cap, n, stride = capacities[lv], len(c), 2**lv
        out.kmap3.append(make_kmap(lv, c, _offsets(3, stride), cap))
        coords_pad = np.zeros((cap, 3), dtype=np.int32)
        coords_pad[:n] = c
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = True
        out.coords.append(coords_pad)
        out.valid.append(valid)
        out.num.append(n)
        if lv == 0 and stem_kernel:
            out.kmap5 = make_kmap(0, c, _offsets(stem_kernel, 1), cap)
        if lv + 1 < num_levels:
            out.down.append(make_kmap(
                lv, level_coords[lv + 1], _offsets(2, stride), capacities[lv + 1]
            ))
            pp, oo = make_parent(lv, c, cap)
            out.up_parent.append(pp)
            out.up_octant.append(oo)
    return out


def stack_hierarchies(hs: Sequence[HostHierarchy], device="cpu") -> SparseHierarchy:
    """Stack per-sample host hierarchies into one batched SparseHierarchy."""

    def st(arrs):
        return torch.from_numpy(np.stack(arrs, axis=0)).to(device)

    n_lv = len(hs[0].coords)

    levels = tuple(
        SparseLevel(
            coords=st([h.coords[i] for h in hs]),
            valid=st([h.valid[i] for h in hs]),
            kmap3=st([h.kmap3[i] for h in hs]),
            num=st([np.int32(h.num[i]) for h in hs]),
        )
        for i in range(n_lv)
    )
    return SparseHierarchy(
        levels=levels,
        down=tuple(st([h.down[i] for h in hs]) for i in range(n_lv - 1)),
        up_parent=tuple(st([h.up_parent[i] for h in hs]) for i in range(n_lv - 1)),
        up_octant=tuple(st([h.up_octant[i] for h in hs]) for i in range(n_lv - 1)),
        kmap5=st([h.kmap5 for h in hs]),
    )


# ---------------------------------------------------------------------------
# Plain ops
# ---------------------------------------------------------------------------


def gather_voxels(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, V, C), idx (B, M) -> (B, M, C); idx < 0 gives zero rows."""
    safe = idx.clamp(0, feats.shape[1] - 1).long()
    g = torch.gather(feats, 1, safe[..., None].expand(-1, -1, feats.shape[2]))
    return torch.where((idx >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))


def sparse_conv_reference(
    feats: torch.Tensor,  # (B, V_in, C_in)
    weights: torch.Tensor,  # (K, C_in, C_out)
    kmap: torch.Tensor,  # (B, K, V_out) int32
    bias: Optional[torch.Tensor] = None,
    out_valid: Optional[torch.Tensor] = None,  # (B, V_out) bool
) -> torch.Tensor:
    """Plain gather + matmul formulation of the sparse conv (the kernel's
    contract): fp32 accumulation over taps, bias, zeroed invalid rows."""
    w = weights.to(feats.dtype).float()
    b, v_out = kmap.shape[0], kmap.shape[2]
    out = torch.zeros((b, v_out, w.shape[2]), dtype=torch.float32, device=feats.device)
    for k in range(w.shape[0]):
        out += gather_voxels(feats, kmap[:, k]).float() @ w[k]
    if bias is not None:
        out = out + bias.float()
    out = out.to(feats.dtype)
    if out_valid is not None:
        out = torch.where(out_valid[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


_CHECKPOINT: contextvars.ContextVar[bool] = contextvars.ContextVar("checkpoint", default=True)


@contextlib.contextmanager
def saving_taps() -> Iterator[None]:
    """Keep every tap's gathered rows for the backward (no recompute)."""
    token = _CHECKPOINT.set(False)
    try:
        yield
    finally:
        _CHECKPOINT.reset(token)


def sparse_conv(feats, weights, kmap, bias=None, out_valid=None) -> torch.Tensor:
    """The sparse conv of the model: its plain formulation. Under autograd
    it is checkpointed: autograd would keep each tap's gathered rows (27
    copies of the input at a k3 conv, tens of GB at a training batch), so
    the backward gathers them again."""
    record("sparse_conv", feats=feats, weights=weights, kmap=kmap, bias=bias, out_valid=out_valid)
    if _CHECKPOINT.get() and torch.is_grad_enabled() and (
            feats.requires_grad or weights.requires_grad):
        return checkpoint(sparse_conv_reference, feats, weights, kmap, bias, out_valid,
                          use_reentrant=False)
    return sparse_conv_reference(feats, weights, kmap, bias=bias, out_valid=out_valid)


def sparse_conv_transpose(
    feats: torch.Tensor,  # (B, V_coarse, C_in)
    weights: torch.Tensor,  # (8, C_in, C_out)
    parent: torch.Tensor,  # (B, V_fine) int32
    octant: torch.Tensor,  # (B, V_fine) int32 in [0, 8)
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Transposed conv (kernel 2, stride 2): Y_k = feats @ W_k for the 8
    octants, then each fine voxel picks Y[octant, parent]."""
    record("sparse_conv_transpose", feats=feats, weights=weights, parent=parent)
    y = torch.einsum("bvc,kco->bkvo", feats, weights.to(feats.dtype))
    b, _, v_coarse, c_out = y.shape
    flat = y.reshape(b, 8 * v_coarse, c_out)
    idx = (octant.long() * v_coarse + parent.clamp(0, v_coarse - 1).long())
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c_out))
    out = torch.where((parent >= 0)[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
