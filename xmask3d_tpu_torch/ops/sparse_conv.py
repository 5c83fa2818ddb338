"""Sparse 3D convolution: host kernel-map builder, plain ops and kernel K1.

Counterpart of `xmask3d_tpu/ops/sparse_conv.py` (hierarchy, plain ops) and
`xmask3d_tpu/ops/sparse_conv_pallas.py` (the kernel). A Minkowski conv is
`out[b, v] = sum_k feats[b, kmap[b, k, v]] @ W[k]` over a dense int32 gather
table `kmap` (-1 = no neighbour); transposed convs are parent gathers.

Kernel offsets enumerate with the last axis fastest; odd kernels span
-(k//2)..k//2 per axis and kernel 2 spans {0, 1}, in units of the level's
tensor stride. `sparse_conv` is differentiable in feats, weights and bias.
A call that carries its map's transpose (`transpose=`: `SAME_LEVEL` for a
level's own `kmap3` / `kmap5`, `down_transposes(h)[s]` for `down[s]`) takes
the gather form of the backward: the feature gradient is K1 itself on the
output gradient through the transposed map, the weight gradient one
gather-product kernel (`sparse_conv_backward_reference` is its plain
statement). Any other call's backward is the plain version's VJP.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from xmask3d_tpu_torch.data import native
from xmask3d_tpu_torch.ops import _build

# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseLevel:
    """One stride level of the voxel hierarchy (static capacity).

    The optional brick fields describe the level's 4x4x4 brick-dense layout
    (`ops/brick_conv.py`, built with `build_hierarchy(..., brick_divisor)`):
    `slot_of_rank[b, v] = brick * 64 + slot` (-1 for padding and for voxels
    whose brick overflowed the brick capacity NB), `nbr27[b, o, n]` the
    brick index of brick n's o-th 3^3 neighbour (-1 absent), `slot_valid`
    the occupied slots of the (NB * 64)-row layout."""

    coords: torch.Tensor  # (B, V, 3) int32, zero-padded
    valid: torch.Tensor  # (B, V) bool
    kmap3: torch.Tensor  # (B, 27, V) int32
    num: torch.Tensor  # (B,) int32
    nbr27: Optional[torch.Tensor] = None  # (B, 27, NB) int32
    slot_of_rank: Optional[torch.Tensor] = None  # (B, V) int32
    slot_valid: Optional[torch.Tensor] = None  # (B, NB * 64) bool


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
    # per level (nbr27, slot_of_rank, slot_valid), when built with bricks
    bricks: Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None


# ---------------------------------------------------------------------------
# Host builders: the C++ one (`data/native.py`) and the numpy one it is held
# against, both exact over 20-bit-per-axis int64 keys
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


def brick_metadata(coords: np.ndarray, stride: int, nb_cap: int, v_cap: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One level's 4x4x4 brick layout (see `SparseLevel`): (nbr27 (27,
    nb_cap), slot_of_rank (v_cap,), slot_valid (nb_cap * 64,)). Bricks are
    kept in packed-key order; bricks beyond nb_cap are dropped and their
    voxels get slot -1, with a warning that counts them (the brick path
    zeroes them for the whole stage)."""
    n = len(coords)
    cu = coords.astype(np.int64) // stride
    bid = cu // 4
    slot = cu - bid * 4
    slot_id = slot[:, 0] * 16 + slot[:, 1] * 4 + slot[:, 2]
    ukeys, first, binv = np.unique(_pack(bid.astype(np.int32)), return_index=True,
                                   return_inverse=True)
    binv = binv.reshape(-1)
    nb = min(len(ukeys), nb_cap)
    slot_of_rank = np.full((v_cap,), -1, np.int32)
    keep = binv < nb_cap
    dropped = int(n - keep.sum())
    if dropped:
        import warnings

        warnings.warn(f"brick_metadata: {dropped}/{n} voxels overflow nb_cap={nb_cap} bricks "
                      "and will be zeroed in the brick conv path (raise brick_divisor's nb_cap)",
                      RuntimeWarning, stacklevel=2)
    slot_of_rank[:n][keep] = (binv[keep] * 64 + slot_id[keep]).astype(np.int32)
    ubid = bid[first[:nb]]
    order = np.arange(len(ukeys), dtype=np.int32)
    nbr27 = np.full((27, nb_cap), -1, np.int32)
    for o, off in enumerate(_offsets(3, 1)):
        hit = _lookup(ukeys, order, _pack((ubid + off[None, :]).astype(np.int32)))
        nbr27[o, :nb] = np.where(hit < nb_cap, hit, -1)
    slot_valid = np.zeros((nb_cap * 64,), bool)
    slot_valid[slot_of_rank[:n][keep]] = True
    return nbr27, slot_of_rank, slot_valid


def build_hierarchy(
    coords: np.ndarray,
    capacities: Sequence[int],
    num_levels: int = 5,
    stem_kernel: int = 5,
    builder: str = "native",
    brick_divisor: int = 0,
) -> HostHierarchy:
    """Full stride hierarchy + kernel maps for one voxelized sample.

    coords: (N, 3) non-negative, deduplicated voxel coords at stride 1.
    capacities: per-level static voxel capacities; voxels beyond a level's
    capacity are dropped. builder: "native", the C++ hash-table builder
    (`data/native.py`; it raises if it cannot be built), or "numpy", the
    sorted-key builder it is held against. Both give the same maps bit for
    bit, as the JAX package's `build_hierarchy` does. brick_divisor > 0 also
    builds each level's brick metadata (`brick_metadata`, numpy, with
    nb_cap = max(16, capacity // brick_divisor)) for the opt-in brick conv
    path; the default 0 builds none, as the device builder builds none."""
    if len(capacities) != num_levels:
        raise ValueError("one capacity per level")
    if builder not in ("native", "numpy"):
        raise ValueError(f"builder must be 'native' or 'numpy', got {builder!r}")
    coords = np.ascontiguousarray(coords[: capacities[0]], dtype=np.int32)
    level_coords: List[np.ndarray] = [coords]
    for lv in range(1, num_levels):
        s = 2**lv
        if builder == "native":
            level_coords.append(native.unique_parents(level_coords[-1], s, capacities[lv]))
            continue
        parent = (level_coords[-1] // s) * s
        _, idx = np.unique(_pack(parent), return_index=True)
        level_coords.append(parent[np.sort(idx)][: capacities[lv]])

    if builder == "native":
        def make_kmap(in_lv, out_coords, offsets, cap):
            return native.build_kmap(level_coords[in_lv], out_coords, offsets, cap)

        def make_parent(lv, c, cap):
            return native.parent_octant(c, level_coords[lv + 1], 2**lv, cap)
    else:
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

    out = HostHierarchy([], [], [], [], [], [], [], None, [] if brick_divisor else None)
    for lv, c in enumerate(level_coords):
        cap, n, stride = capacities[lv], len(c), 2**lv
        if brick_divisor:
            out.bricks.append(brick_metadata(c, stride, max(16, cap // brick_divisor), cap))
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


def down_transposes(h: SparseHierarchy) -> Tuple[torch.Tensor, ...]:
    """The transpose of each stride-2 down map, for the gather form of its
    backward: down_t[s][b, k, u] = up_parent[s][b, u] where up_octant[s][b, u]
    is k, else -1, (B, 8, V_s) int32 (each voxel has one parent and one
    octant). Built on the maps' device on first use and kept on `h`; built
    again when `up_parent` or `up_octant` is replaced or written in place."""
    leaves = (*h.up_parent, *h.up_octant)
    versions = tuple(t._version for t in leaves)
    kept = h.__dict__.get("_down_t")
    if kept is not None and kept[1] == versions and all(a is b for a, b in zip(kept[0], leaves)):
        return kept[2]
    out = []
    for parent, octant in zip(h.up_parent, h.up_octant):
        taps = torch.arange(8, dtype=octant.dtype, device=octant.device)[None, :, None]
        none = torch.full((), -1, dtype=torch.int32, device=parent.device)
        out.append(torch.where(octant[:, None, :] == taps, parent[:, None, :].to(torch.int32),
                               none).contiguous())
    h.__dict__["_down_t"] = (leaves, versions, tuple(out))
    return h.__dict__["_down_t"][2]


def stack_hierarchies(hs: Sequence[HostHierarchy], device="cpu") -> SparseHierarchy:
    """Stack per-sample host hierarchies into one batched SparseHierarchy."""

    def st(arrs):
        return torch.from_numpy(np.stack(arrs, axis=0)).to(device)

    n_lv = len(hs[0].coords)
    if len({h.bricks is None for h in hs}) != 1:
        raise ValueError("stack_hierarchies: samples built with and without bricks")

    def bricks(i):
        if hs[0].bricks is None:
            return {}
        return {k: st([h.bricks[i][j] for h in hs])
                for j, k in enumerate(("nbr27", "slot_of_rank", "slot_valid"))}

    levels = tuple(
        SparseLevel(
            coords=st([h.coords[i] for h in hs]),
            valid=st([h.valid[i] for h in hs]),
            kmap3=st([h.kmap3[i] for h in hs]),
            num=st([np.int32(h.num[i]) for h in hs]),
            **bricks(i),
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


def sparse_conv_backward_reference(
    g: torch.Tensor,  # (B, V_out, C_out)
    feats: torch.Tensor,  # (B, V_in, C_in)
    weights: torch.Tensor,  # (K, C_in, C_out)
    kmap: torch.Tensor,  # (B, K, V_out) int32
    transpose,  # SAME_LEVEL or (B, K, V_in) int32
    bias: Optional[torch.Tensor] = None,
    out_valid: Optional[torch.Tensor] = None,
    needs: Sequence[bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], ...]:
    """The gather form of `sparse_conv`'s VJP under cotangent g (the backward
    kernels' contract), (dfeats, dweights, dbias), None where `needs` says
    so; fp32 accumulation, each gradient cast once to its input's dtype.
    Rows of g outside `out_valid` count as zero. With the map's transpose
    (see `sparse_conv`), tap k's pairs (v, u) are tap k's pairs (u, v) of
    the transposed map, so
        dfeats[u] = sum_k g[kmap_t[k, u]] W[k]^T   (SAME_LEVEL: kmap_t[k] = kmap[K-1-k])
        dW[k] = sum_v feats[kmap[k, v]]^T g[v]      db = sum_v g[v]
    with gathers only. It equals the plain VJP up to summation order."""
    gf = g.float()
    if out_valid is not None:
        gf = torch.where(out_valid[..., None], gf, torch.zeros((), device=gf.device))
    w = weights.float()
    b, v_in, c_in = feats.shape
    df = dw = db = None
    if needs[0]:
        same = isinstance(transpose, str)
        m, wt = (kmap, w.flip(0)) if same else (transpose, w)
        acc = torch.zeros((b, v_in, c_in), dtype=torch.float32, device=feats.device)
        for k in range(w.shape[0]):
            acc += gather_voxels(gf, m[:, k]) @ wt[k].T
        df = acc.to(feats.dtype)
    if needs[1]:
        f = feats.float()
        dw = torch.stack([torch.einsum("bvc,bvo->co", gather_voxels(f, kmap[:, k]), gf)
                          for k in range(w.shape[0])]).to(weights.dtype)
    if needs[2] and bias is not None:
        db = gf.sum((0, 1)).to(bias.dtype)
    return df, dw, db


# output channels a block of the tensor-core kernel can hold, the rows of a
# block and of a warp's strip, and the card's SM count; all mirror
# csrc/sparse_conv.cu
MMA_WIDTHS = (32, 64, 128, 256)
TILE_ROWS, STRIP_ROWS = 64, 16
SM_COUNT = 132


def kernel_plan(dtype: torch.dtype, n_taps: int, c_in: int, c_out: int, v_out: int,
                aligned: bool = True) -> Tuple[str, int, int, bool, int]:
    """(variant name, output channels a block holds, K values a staged chunk,
    packed mode, K split) of the kernel a call takes. bf16 runs on the tensor
    cores: rows gathered by 16-byte copies when both widths are multiples of
    8 (and the pointers `aligned` to 16 bytes), else taps and channels packed
    into one K dimension by scalar loads. A block holds all of C_out up to
    256, but where the level's 64-row tiles would leave SMs idle it narrows,
    down to 64 channels, and C_out is tiled over the grid. Where even that
    gives fewer than two blocks an SM (the deep levels, where moreover few
    rows are live), the taps of a tile are split over `split` blocks, aiming
    at eight blocks an SM by capacity, and a second small kernel adds their
    fp32 partial sums. Chunks are 64 channels where C_in is a multiple of 64,
    else 32. fp32 runs on CUDA cores."""
    if dtype == torch.float32:
        return "fma_fp32", 0, 0, False, 1
    nc = next((w for w in MMA_WIDTHS if c_out <= w), MMA_WIDTHS[-1])
    tiles = -(-v_out // TILE_ROWS)
    while nc > 64 and tiles * -(-c_out // nc) < SM_COUNT:
        nc //= 2
    packed = not (aligned and c_in % 8 == 0 and c_out % 8 == 0)
    kc = 64 if (c_in % 64 == 0 and not packed) else 32
    blocks = max(1, tiles * -(-c_out // nc))
    units = -(-n_taps * c_in // kc) if packed else n_taps
    split = 1 if blocks >= 2 * SM_COUNT else max(1, min(units, -(-8 * SM_COUNT // blocks)))
    name = f"mma_{'packed' if packed else 'gather'}_n{nc}_k{kc}" + (f"_s{split}" if split > 1 else "")
    return name, nc, kc, packed, split


# the weight gradient's kernel: output channels a block can hold, rows of dW
# (input channels, or packed (tap, channel) pairs) a block holds, and the
# most 16-row strips a block lists; mirror csrc/sparse_conv.cu
WGRAD_WIDTHS = (32, 64, 96, 128)
WGRAD_ROWS, WGRAD_LIST = 64, 2048


def wgrad_plan(n_taps: int, c_in: int, c_out: int, rows: int, packed: bool,
               want_w: bool = True, want_b: bool = False) -> Tuple[int, int, int]:
    """(output channels a block holds, blocks along dW's rows, row split) of
    the weight-gradient kernel. Blocks along dW's rows: a tap's C_in in
    64-row tiles for each tap, or the packed K * C_in in 64-row tiles (and
    none where only the bias gradient is asked); the bias takes one more
    row of blocks. The output rows are dealt out over `split` blocks, aiming
    at four blocks an SM by capacity, with at least 16 strips a block and at
    most WGRAD_LIST."""
    bn = next((w for w in WGRAD_WIDTHS if c_out <= w), WGRAD_WIDTHS[-1])
    m_units = 0
    if want_w:
        m_units = (-(-n_taps * c_in // WGRAD_ROWS) if packed
                   else n_taps * -(-c_in // WGRAD_ROWS))
    base = -(-c_out // bn) * (m_units + int(want_b))
    strips = -(-rows // STRIP_ROWS)
    split = max(1, min(-(-4 * SM_COUNT // base), strips // 16), -(-strips // WGRAD_LIST))
    return bn, m_units, split


def variant(feats: torch.Tensor, weights: torch.Tensor, kmap: torch.Tensor) -> str:
    """The kernel variant `sparse_conv(feats, weights, kmap, ...)` launches on
    the card: a pure function of shapes and dtype (tensors from the allocator
    are aligned; a misaligned view takes the packed mode of the same width)."""
    return kernel_plan(feats.dtype, *weights.shape, kmap.shape[2])[0]


def strip_tap_steps(kmap: torch.Tensor, out_valid: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(steps, steps with a hit) over the (16-row strip, tap) pairs of every
    64-row tile that has a live output row: what the gather variant walks and
    what it multiplies. A strip skips a tap none of its live rows hits."""
    b, k, v = kmap.shape
    live = torch.ones((b, v), dtype=torch.bool, device=kmap.device) if out_valid is None else out_valid
    pad = -v % TILE_ROWS
    hit = torch.nn.functional.pad((kmap >= 0) & live[:, None, :], (0, pad))
    live = torch.nn.functional.pad(live, (0, pad))
    strips = hit.reshape(b, k, -1, STRIP_ROWS).any(-1)  # (B, K, V / 16)
    tiles = live.reshape(b, -1, TILE_ROWS).any(-1)  # (B, V / 64)
    per_tile = TILE_ROWS // STRIP_ROWS
    return int(tiles.sum()) * per_tile * k, int(strips.sum())


# the marker of a map of one level onto itself (`kmap3`, `kmap5`): its
# offsets are symmetric, so tap K-1-k is tap k's transpose
SAME_LEVEL = "same_level"


def sparse_conv(
    feats: torch.Tensor,
    weights: torch.Tensor,
    kmap: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_valid: Optional[torch.Tensor] = None,
    transpose=None,
) -> torch.Tensor:
    """Sparse conv: kernel K1 on CUDA tensors, the plain version on CPU ones
    (same checks on both). `transpose`, the map's transpose, selects the
    gather form of the backward: SAME_LEVEL, or a (B, K, V_in) int32 map with
    transpose[b, k, u] = v where kmap[b, k, v] = u and -1 elsewhere (each
    tap then hits an input row once at most). Without it the backward is
    the plain version's VJP."""
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sparse_conv: unsupported device {feats.device}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sparse_conv: unsupported dtype {feats.dtype}")
    if feats.ndim != 3 or weights.ndim != 3 or kmap.ndim != 3:
        raise ValueError("sparse_conv: feats (B,V,C), weights (K,Ci,Co), kmap (B,K,V)")
    b, _, c_in = feats.shape
    k, wc_in, c_out = weights.shape
    if wc_in != c_in or kmap.shape[0] != b or kmap.shape[1] != k:
        raise ValueError(
            f"sparse_conv: shapes feats {tuple(feats.shape)} weights "
            f"{tuple(weights.shape)} kmap {tuple(kmap.shape)} disagree"
        )
    if kmap.dtype != torch.int32:
        raise TypeError("sparse_conv: kmap must be int32")
    if weights.dtype != feats.dtype:
        raise TypeError(f"sparse_conv: weights {weights.dtype} != feats {feats.dtype}")
    v_out = kmap.shape[2]
    if bias is not None and bias.shape != (c_out,):
        raise ValueError(f"sparse_conv: bias must be ({c_out},)")
    if out_valid is not None and (out_valid.shape != (b, v_out) or out_valid.dtype != torch.bool):
        raise ValueError("sparse_conv: out_valid must be bool (B, V_out)")
    _build.require_contiguous("sparse_conv", feats, weights, kmap, bias, out_valid)
    for t in (weights, kmap, bias, out_valid):
        if t is not None and t.device != feats.device:
            raise ValueError("sparse_conv: all tensors must be on one device")
    if isinstance(transpose, str):
        if transpose != SAME_LEVEL or v_out != feats.shape[1]:
            raise ValueError("sparse_conv: transpose must be SAME_LEVEL (a map of one level "
                             "onto itself, V_out == V_in) or a (B, K, V_in) int32 map")
    elif transpose is not None:
        if (transpose.shape != (b, k, feats.shape[1]) or transpose.dtype != torch.int32
                or transpose.device != feats.device or not transpose.is_contiguous()):
            raise ValueError(f"sparse_conv: transpose must be a contiguous int32 (B, K, V_in) map "
                             f"on the features' device, got {tuple(transpose.shape)}")
    _build.record("sparse_conv", feats, weights, kmap, bias, out_valid)
    return _SparseConv.apply(feats, weights, bias, kmap, out_valid, transpose)


class _SparseConv(torch.autograd.Function):
    """K1 with gradients for feats, weights and bias (in the bias's own
    dtype, though the kernel reads it as fp32); the kernel map and the
    output mask take none. A call with its map's transpose takes the gather
    form of the backward (`_launch_backward` on the card in bf16,
    `sparse_conv_backward_reference` otherwise), any other the plain
    version's VJP (the JAX package's `_spconv2_hybrid`). The backward
    launches through the library, not `sparse_conv`: the recorder and
    `sparse_conv.launches` see forward calls only; `backward_calls` counts
    the backwards by form."""

    @staticmethod
    def forward(ctx, feats, weights, bias, kmap, out_valid, transpose):
        ctx.same_level = isinstance(transpose, str)
        ctx.gather_form = transpose is not None
        kmap_t = None if ctx.same_level else transpose
        ctx.save_for_backward(feats, weights, bias, kmap, out_valid, kmap_t)
        if feats.device.type == "cpu":
            return sparse_conv_reference(feats, weights, kmap, bias, out_valid)
        return _launch(feats, weights, kmap, bias, out_valid)

    @staticmethod
    def backward(ctx, g):
        feats, weights, bias, kmap, out_valid, kmap_t = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if not ctx.gather_form:
            sparse_conv.backward_calls["plain"] += 1
            grads = _build.plain_vjp(
                lambda f, w, b: sparse_conv_reference(f, w, kmap, b, out_valid),
                (feats, weights, bias), needs, g)
            return (*grads, None, None, None)
        sparse_conv.backward_calls["kernel"] += 1
        transpose = SAME_LEVEL if ctx.same_level else kmap_t
        on_kernels = feats.device.type == "cuda" and feats.dtype == torch.bfloat16
        backward = _launch_backward if on_kernels else sparse_conv_backward_reference
        grads = backward(g, feats, weights, kmap, transpose, bias, out_valid, needs)
        return (*grads, None, None, None)


def _launch(feats, weights, kmap, bias, out_valid) -> torch.Tensor:
    b, v_in, c_in = feats.shape
    k, _, c_out = weights.shape
    v_out = kmap.shape[2]
    bias_f = bias.float() if bias is not None else None
    valid_u8 = out_valid.view(torch.uint8) if out_valid is not None else None
    out = torch.empty((b, v_out, c_out), dtype=feats.dtype, device=feats.device)
    lib = _build.load("sparse_conv")
    ptrs = (_build.ptr(feats), _build.ptr(weights), _build.ptr(kmap), _build.ptr(bias_f),
            _build.ptr(valid_u8), _build.ptr(out))
    dims = (b, v_in, c_in, c_out, k, v_out)
    if feats.dtype == torch.bfloat16:
        aligned = feats.data_ptr() % 16 == 0 and weights.data_ptr() % 16 == 0
        _, nc, kc, packed, split = kernel_plan(feats.dtype, k, c_in, c_out, v_out, aligned)
        part = None  # fp32 scratch for the K shares; only live tiles are written and read
        if split > 1:
            part = torch.empty((split, b, v_out, c_out), dtype=torch.float32, device=feats.device)
        err = lib.xm_sparse_conv_bf16(*ptrs, _build.ptr(part), *dims, nc, kc, int(packed), split,
                                      _build.stream(feats.device))
    else:
        err = lib.xm_sparse_conv_f32(*ptrs, *dims, _build.stream(feats.device))
    _build.check(err, "sparse_conv")
    sparse_conv.launches += 1
    return out


sparse_conv.launches = 0
# backwards by form: "kernel" the gather form (its kernels on the card in
# bf16, its plain statement otherwise), "plain" the plain VJP
sparse_conv.backward_calls = {"kernel": 0, "plain": 0}


def _launch_backward(g, feats, weights, kmap, transpose, bias, out_valid, needs):
    """The gather form of the backward on the card (bf16): the feature
    gradient through `k1_dgrad_*` (K1's body on g, the transposed map and
    the flipped, transposed weights), the weight and bias gradients through
    `k1_wgrad_*` (partial products, then a fixed-order sum): deterministic."""
    b, v_in, c_in = feats.shape
    k, _, c_out = weights.shape
    v_out = kmap.shape[2]
    dev = feats.device
    g = g.contiguous()
    lib = _build.load("sparse_conv")
    stream = _build.stream(dev)
    df = dw = db = None
    if needs[0]:
        g_m = g if out_valid is None else torch.where(
            out_valid[..., None], g, torch.zeros((), dtype=g.dtype, device=dev))
        same = isinstance(transpose, str)
        w_t = (weights.flip(0) if same else weights).transpose(1, 2).contiguous()
        kmap_t = kmap if same else transpose
        df = torch.empty((b, v_in, c_in), dtype=feats.dtype, device=dev)
        aligned = g_m.data_ptr() % 16 == 0 and w_t.data_ptr() % 16 == 0
        # planned on the tiles of the whole batch, all of which the grid holds
        _, nc, kc, packed, split = kernel_plan(feats.dtype, k, c_out, c_in, b * v_in, aligned)
        part = None
        if split > 1:
            part = torch.empty((split, b, v_in, c_in), dtype=torch.float32, device=dev)
        _build.check(lib.xm_k1_dgrad_bf16(
            _build.ptr(g_m), _build.ptr(w_t), _build.ptr(kmap_t), _build.ptr(df),
            _build.ptr(part), b, v_out, c_out, c_in, k, v_in, nc, kc, int(packed), split,
            stream), "sparse_conv backward (features)")
    want_b = bool(needs[2]) and bias is not None
    if needs[1] or want_b:
        packed = not (c_in % 8 == 0 and feats.data_ptr() % 16 == 0)
        g_vec = c_out % 8 == 0 and g.data_ptr() % 16 == 0
        bn, m_units, split = wgrad_plan(k, c_in, c_out, b * v_out, packed, bool(needs[1]), want_b)
        part = torch.empty((split, k * c_in + 1, c_out), dtype=torch.float32, device=dev)
        dw = torch.empty_like(weights) if needs[1] else None
        db = torch.empty((c_out,), dtype=torch.float32, device=dev) if want_b else None
        valid_u8 = out_valid.view(torch.uint8) if out_valid is not None else None
        _build.check(lib.xm_k1_wgrad_bf16(
            _build.ptr(feats), _build.ptr(g), _build.ptr(kmap), _build.ptr(valid_u8),
            _build.ptr(part), _build.ptr(dw), _build.ptr(db), b, v_in, c_in, c_out, k, v_out,
            bn, int(packed), int(g_vec), m_units, split, stream), "sparse_conv backward (weights)")
        if want_b:
            db = db.to(bias.dtype)
    return df, dw, db


def _bind(lib):
    import ctypes

    for name, ptrs, ints in (("xm_sparse_conv_f32", 6, 6), ("xm_sparse_conv_bf16", 7, 10),
                             ("xm_k1_dgrad_bf16", 5, 10), ("xm_k1_wgrad_bf16", 7, 11)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


_build.BINDERS["sparse_conv"] = _bind


def sparse_conv_transpose(
    feats: torch.Tensor,  # (B, V_coarse, C_in)
    weights: torch.Tensor,  # (8, C_in, C_out)
    parent: torch.Tensor,  # (B, V_fine) int32
    octant: torch.Tensor,  # (B, V_fine) int32 in [0, 8)
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Transposed conv (kernel 2, stride 2): Y_k = feats @ W_k for the 8
    octants, then each fine voxel picks Y[octant, parent]."""
    y = torch.einsum("bvc,kco->bkvo", feats, weights.to(feats.dtype))
    b, _, v_coarse, c_out = y.shape
    flat = y.reshape(b, 8 * v_coarse, c_out)
    idx = (octant.long() * v_coarse + parent.clamp(0, v_coarse - 1).long())
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c_out))
    out = torch.where((parent >= 0)[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def global_max_pool(feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-scene max over valid voxels: (B, V, C), (B, V) -> (B, C)."""
    neg = torch.finfo(feats.dtype).min
    return torch.where(valid[..., None], feats, torch.full((), neg, dtype=feats.dtype, device=feats.device)).amax(dim=1)
