"""Sparse 3D convolution: host kernel-map builder, plain ops and kernel K1.

Counterpart of `xmask3d_tpu/ops/sparse_conv.py` (hierarchy, plain ops) and
`xmask3d_tpu/ops/sparse_conv_pallas.py` (the kernel). A Minkowski conv is
`out[b, v] = sum_k feats[b, kmap[b, k, v]] @ W[k]` over a dense int32 gather
table `kmap` (-1 = no neighbour); transposed convs are parent gathers.

Kernel offsets enumerate with the last axis fastest; odd kernels span
-(k//2)..k//2 per axis and kernel 2 spans {0, 1}, in units of the level's
tensor stride. `sparse_conv` is differentiable in feats, weights and bias:
its backward is the plain version's VJP.
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


def build_hierarchy(
    coords: np.ndarray,
    capacities: Sequence[int],
    num_levels: int = 5,
    stem_kernel: int = 5,
    builder: str = "native",
) -> HostHierarchy:
    """Full stride hierarchy + kernel maps for one voxelized sample.

    coords: (N, 3) non-negative, deduplicated voxel coords at stride 1.
    capacities: per-level static voxel capacities; voxels beyond a level's
    capacity are dropped. builder: "native", the C++ hash-table builder
    (`data/native.py`; it raises if it cannot be built), or "numpy", the
    sorted-key builder it is held against. Both give the same maps bit for
    bit, as the JAX package's `build_hierarchy` does."""
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


def sparse_conv(
    feats: torch.Tensor,
    weights: torch.Tensor,
    kmap: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sparse conv: kernel K1 on CUDA tensors, the plain version on CPU ones
    (same checks on both)."""
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
    _build.record("sparse_conv", feats, weights, kmap, bias, out_valid)
    return _SparseConv.apply(feats, weights, bias, kmap, out_valid)


class _SparseConv(torch.autograd.Function):
    """K1 with the plain version's VJP as its backward (the JAX package's
    `_spconv2_hybrid`): gradients for feats, weights and bias (in the
    bias's own dtype, though the kernel reads it as fp32); the kernel map
    and the output mask take none."""

    @staticmethod
    def forward(ctx, feats, weights, bias, kmap, out_valid):
        ctx.save_for_backward(feats, weights, bias, kmap, out_valid)
        if feats.device.type == "cpu":
            return sparse_conv_reference(feats, weights, kmap, bias, out_valid)
        return _launch(feats, weights, kmap, bias, out_valid)

    @staticmethod
    def backward(ctx, g):
        feats, weights, bias, kmap, out_valid = ctx.saved_tensors
        grads = _build.plain_vjp(
            lambda f, w, b: sparse_conv_reference(f, w, kmap, b, out_valid),
            (feats, weights, bias), ctx.needs_input_grad[:3], g)
        return (*grads, None, None)


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


def _bind(lib):
    import ctypes

    for name, ptrs, ints in (("xm_sparse_conv_f32", 6, 6), ("xm_sparse_conv_bf16", 7, 10)):
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
