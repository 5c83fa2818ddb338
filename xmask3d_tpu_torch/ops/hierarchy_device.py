"""The sparse voxel hierarchy built on the device, inside the forward.

Counterpart of `xmask3d_tpu/ops/hierarchy_device.py`. The host builders
(`ops/sparse_conv.py` `build_hierarchy`) make ~19 MB of kernel maps a view
at the bench's capacities, which cross from the host every view. This
module builds the same `SparseHierarchy` on the device from the padded
(B, V0, 3) voxel coords and the (B,) counts: packed int32 keys, a sort,
`searchsorted`, a cumulative sum and an in-bounds scatter-min.

Level 0 keeps the caller's row order (the voxel features and
`inds_reconstruct` index it), so its maps equal the host's. Deeper levels
hold their voxels in sorted-key order, not the host builders'
first-occurrence order: the same voxel sets, with rows permuted.

It is plain PyTorch and capturable into a CUDA graph: every shape is
static, nothing reads a value back to the host, and the kernel offsets are
device constants filled by the first (eager) call.
"""

from __future__ import annotations

from typing import Sequence

import torch

from xmask3d_tpu_torch.device import device_constant
from xmask3d_tpu_torch.ops.sparse_conv import SparseHierarchy, SparseLevel, _offsets

# int32 keys: 10 bits per axis, 1024 voxels an axis (20 m at 2 cm voxels);
# `collate_views` clips stride-1 coords to [0, 1023]. The sentinel sorts
# after every real key and is never a hit.
_BITS = 10
_EXTENT = 1 << _BITS
_SENT = (1 << 30) + 1


def _pack(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.int32)
    key = (c[..., 0] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 2]
    # out-of-range components (neighbour queries past the grid's edge) must
    # never alias a real key
    in_range = ((c >= 0) & (c < _EXTENT)).all(-1)
    return key.masked_fill(~(valid & in_range), _SENT)


def _unpack(keys: torch.Tensor) -> torch.Tensor:
    mask = _EXTENT - 1
    return torch.stack([(keys >> (2 * _BITS)) & mask, (keys >> _BITS) & mask, keys & mask],
                       dim=-1).to(torch.int32)


class _SortedIndex:
    """A level's keys sorted, with each sorted key's original row."""

    def __init__(self, keys: torch.Tensor):  # (B, N) int32
        self.order = torch.argsort(keys, dim=-1, stable=True)
        self.sorted_keys = torch.gather(keys, -1, self.order).contiguous()

    def lookup(self, queries: torch.Tensor) -> torch.Tensor:
        """(B, M) int32 keys -> the row holding each, -1 where none does."""
        pos = torch.searchsorted(self.sorted_keys, queries.contiguous())
        pos = pos.clamp(0, self.sorted_keys.shape[-1] - 1)
        hit = (torch.gather(self.sorted_keys, -1, pos) == queries) & (queries != _SENT)
        rows = torch.gather(self.order, -1, pos).to(torch.int32)
        return rows.masked_fill(~hit, -1)


def _offsets_on(kernel_size: int, stride: int, device) -> torch.Tensor:
    return device_constant(("hierarchy_offsets", kernel_size, stride), device,
                           lambda: torch.from_numpy(_offsets(kernel_size, stride)).to(torch.int32))


def _build_kmap(index: _SortedIndex, out_coords, out_valid, kernel_size: int,
                stride: int) -> torch.Tensor:
    """(B, K, V_out) gather map of every offset at once."""
    offs = _offsets_on(kernel_size, stride, out_coords.device)  # (K, 3)
    b, v = out_valid.shape
    q = _pack(out_coords[:, None] + offs[None, :, None], out_valid[:, None])  # (B, K, V)
    return index.lookup(q.reshape(b, -1)).reshape(b, offs.shape[0], v)


def _downsample(coords, valid, stride2: int, cap_out: int):
    """The distinct (c // stride2 * stride2) in sorted-key order, compacted
    into `cap_out` rows: (coords, valid, count)."""
    b = coords.shape[0]
    keys = _pack((coords // stride2) * stride2, valid)
    sk = torch.sort(keys, dim=-1).values
    prev = torch.cat([torch.full((b, 1), -1, dtype=sk.dtype, device=sk.device), sk[:, :-1]], 1)
    is_new = (sk != prev) & (sk != _SENT)
    pos = torch.cumsum(is_new, dim=-1) - 1
    # a scatter strictly in bounds: rows that are not new, or past the
    # capacity, write the sentinel (the largest key) at a clamped slot, and
    # the min-combine keeps the real key there
    slot = torch.where(is_new, pos, cap_out - 1).clamp(0, cap_out - 1)
    val = sk.masked_fill(~(is_new & (pos < cap_out)), _SENT)
    out_keys = torch.full((b, cap_out), _SENT, dtype=torch.int32, device=sk.device)
    out_keys.scatter_reduce_(1, slot, val, "amin", include_self=True)
    n_out = is_new.sum(-1).clamp(max=cap_out).to(torch.int32)
    out_valid = torch.arange(cap_out, device=sk.device)[None] < n_out[:, None]
    out_coords = _unpack(out_keys).masked_fill(~out_valid[..., None], 0)
    return out_coords, out_valid, n_out


def build_hierarchy_on_device(coords: torch.Tensor, num: torch.Tensor,
                              capacities: Sequence[int], stem_kernel: int = 5
                              ) -> SparseHierarchy:
    """The `SparseHierarchy` of a batch from its (B, capacities[0], 3) int32
    zero-padded stride-1 voxel coords and (B,) int32 voxel counts, on their
    device."""
    if coords.shape[1] != capacities[0]:
        raise ValueError(f"coords hold {coords.shape[1]} rows, level 0's capacity is "
                         f"{capacities[0]}")
    n_lv = len(capacities)
    valid0 = torch.arange(capacities[0], device=coords.device)[None] < num[:, None]
    level_coords = [coords.to(torch.int32).masked_fill(~valid0[..., None], 0)]
    level_valid, level_num = [valid0], [num.to(torch.int32)]
    for lv in range(1, n_lv):
        c, v, n = _downsample(level_coords[-1], level_valid[-1], 2**lv, capacities[lv])
        level_coords.append(c)
        level_valid.append(v)
        level_num.append(n)
    indexes = [_SortedIndex(_pack(c, v)) for c, v in zip(level_coords, level_valid)]

    levels, downs, ups_p, ups_o = [], [], [], []
    kmap5 = None
    for lv in range(n_lv):
        c, v, stride = level_coords[lv], level_valid[lv], 2**lv
        levels.append(SparseLevel(coords=c, valid=v, num=level_num[lv],
                                  kmap3=_build_kmap(indexes[lv], c, v, 3, stride)))
        if lv == 0 and stem_kernel:
            kmap5 = _build_kmap(indexes[0], c, v, stem_kernel, 1)
        if lv + 1 < n_lv:
            downs.append(_build_kmap(indexes[lv], level_coords[lv + 1], level_valid[lv + 1],
                                     2, stride))
            s2 = 2 * stride
            ups_p.append(indexes[lv + 1].lookup(_pack((c // s2) * s2, v)))
            oct3 = (c // stride) % 2
            ups_o.append((oct3[..., 0] * 4 + oct3[..., 1] * 2 + oct3[..., 2]).to(torch.int32))
    return SparseHierarchy(levels=tuple(levels), down=tuple(downs), up_parent=tuple(ups_p),
                           up_octant=tuple(ups_o), kmap5=kmap5)


def to_key_order(h: SparseHierarchy) -> SparseHierarchy:
    """A batched hierarchy (levels in the host builders' first-occurrence
    order) with the rows of levels 1-4 in sorted-key order, the device
    builder's: coords and validity permuted, every map's columns permuted
    and its entries renumbered. Where no level past level 0 overflows its
    capacity it equals `build_hierarchy_on_device`'s hierarchy of the same
    voxels, leaf by leaf; it lets a computation whose rounding depends on
    row order (K1's split over a tile's taps) be compared across the two
    routes."""
    perms, inverse = [], []
    for lv, level in enumerate(h.levels):
        b, v = level.valid.shape
        ident = torch.arange(v, device=level.valid.device).expand(b, v)
        p = ident if lv == 0 else torch.argsort(_pack(level.coords, level.valid), dim=-1,
                                                stable=True)
        perms.append(p)
        inverse.append(torch.empty_like(p).scatter_(1, p, ident))

    def cols(m, p):  # (B, ..., V) map columns, or (B, V) rows, in the new order
        return torch.gather(m, -1, p.reshape(p.shape[0], *([1] * (m.dim() - 2)), p.shape[1])
                            .expand_as(m))

    def renumber(m, q):  # entries index a level's rows; -1 stays
        new = torch.gather(q, 1, m.clamp(min=0).reshape(m.shape[0], -1).long()).reshape(m.shape)
        return torch.where(m >= 0, new.to(m.dtype), m)

    levels = tuple(
        SparseLevel(coords=torch.gather(lv.coords, 1, p[..., None].expand_as(lv.coords)),
                    valid=cols(lv.valid, p), kmap3=renumber(cols(lv.kmap3, p), q), num=lv.num)
        for lv, p, q in zip(h.levels, perms, inverse))
    n = len(h.levels)
    return SparseHierarchy(
        levels=levels,
        down=tuple(renumber(cols(h.down[i], perms[i + 1]), inverse[i]) for i in range(n - 1)),
        up_parent=tuple(renumber(cols(h.up_parent[i], perms[i]), inverse[i + 1])
                        for i in range(n - 1)),
        up_octant=tuple(cols(h.up_octant[i], perms[i]) for i in range(n - 1)),
        kmap5=h.kmap5)
