"""Brick-dense sparse convolution (opt-in, `XMASK3D_BRICK=1`).

Counterpart of `xmask3d_tpu/ops/brick_conv.py`. A level's voxels are
grouped into 4x4x4 spatial bricks (`ops/sparse_conv.py` `brick_metadata`),
and a kernel-3 or kernel-5 Minkowski conv becomes a dense 3D conv over
bricks with a halo of r = k // 2 voxels taken from their 26 neighbours:

    compact (B, V, C) --scatter--> bricks (B, NB*64, C)
    halo: 26 neighbour-slab gathers + concatenation -> (B, NB, 4+2r, 4+2r, 4+2r, C)
    one VALID dense conv over each halo'd brick     -> (B, NB*64, C_out)

Empty slots hold zeros and absent neighbour bricks give zero slabs, so on
occupied voxels the result is the gather-table conv's (kernel K1), with the
same submanifold semantics through `slot_valid`. The JAX package computes
the dense part as K shifted-window matmuls in plain XLA; here it is one
`F.conv3d` (cuDNN on the card), the tap order being `_offsets`'
enumeration (last axis fastest), which is the (kx, ky, kz) order of the
conv's weight. No TPU kernel is behind this module: K1 stays the default
3D conv (`XMASK3D_BRICK=1`, read in `models/minkunet.py`, opts in), and
the brick path replaces only the k3 / k5 submanifold convs (the strided
k2 convs and the transposed convs keep their maps).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from xmask3d_tpu_torch.ops.sparse_conv import SparseLevel, gather_voxels


def to_brick(feats: torch.Tensor, slot_of_rank: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Scatter compact (B, V, C) rows into the brick-dense (B, n_slots, C)
    layout. Rows with slot -1 (padding, voxels of overflowed bricks) are
    dropped: they scatter into one spare row past the end, which is cut
    off (a raw -1 would index the last slot)."""
    b, _, c = feats.shape
    out = feats.new_zeros((b, n_slots + 1, c))
    slot = torch.where(slot_of_rank >= 0, slot_of_rank, n_slots).long()
    out.scatter_(1, slot[..., None].expand(-1, -1, c), feats)
    return out[:, :n_slots]


def from_brick(bricks: torch.Tensor, slot_of_rank: torch.Tensor) -> torch.Tensor:
    """Gather brick-dense rows back to the compact layout (-1 gives zeros)."""
    return gather_voxels(bricks, slot_of_rank)


def brick_halo(bricks: torch.Tensor, nbr27: torch.Tensor, r: int) -> torch.Tensor:
    """(B, NB, 4+2r, 4+2r, 4+2r, C) halo'd bricks: for each of the 26
    neighbour offsets only the needed slab (face, edge or corner of the
    halo shell) is sliced out of the bricks and gathered through the
    neighbour table, then the pieces are concatenated z rows -> y planes ->
    x cube. `nbr27` is (B, 27, NB), -1 where a neighbour is absent."""
    b, n_slots, c = bricks.shape
    nb = n_slots // 64
    bf = bricks.reshape(b, nb, 4, 4, 4, c)

    def src(d):
        return slice(4 - r, 4) if d == -1 else slice(0, r) if d == 1 else slice(0, 4)

    def piece(dx, dy, dz):
        if (dx, dy, dz) == (0, 0, 0):
            return bf
        o = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)
        slab = bf[:, :, src(dx), src(dy), src(dz), :]
        return gather_voxels(slab.reshape(b, nb, -1), nbr27[:, o]).reshape(slab.shape)

    rows = [torch.cat([piece(dx, dy, dz) for dz in (-1, 0, 1)], dim=4)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    planes = [torch.cat(rows[3 * i:3 * i + 3], dim=3) for i in range(3)]
    return torch.cat(planes, dim=2)


def brick_conv(bricks: torch.Tensor, weights: torch.Tensor, nbr27: torch.Tensor,
               slot_valid: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense halo'd conv of brick-layout features (B, NB*64, C_in) with
    weights (K, C_in, C_out), K = 27 or 125, in the builder's tap order ->
    brick-layout output (B, NB*64, C_out), zero off `slot_valid`."""
    k, cin, cout = weights.shape
    ks = round(k ** (1.0 / 3.0))
    if ks ** 3 != k:
        raise ValueError(f"brick_conv needs a cubic tap count, got {k}")
    b, n_slots, _ = bricks.shape
    nb = n_slots // 64
    d = 4 + 2 * (ks // 2)
    halo = brick_halo(bricks, nbr27, ks // 2)
    x = halo.reshape(b * nb, d, d, d, cin).permute(0, 4, 1, 2, 3)
    w = weights.to(bricks.dtype).reshape(ks, ks, ks, cin, cout).permute(4, 3, 0, 1, 2)
    out = F.conv3d(x, w).permute(0, 2, 3, 4, 1).reshape(b, n_slots, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if slot_valid is not None:
        out = torch.where(slot_valid[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def level_brick(level: SparseLevel):
    """The level's (nbr27, slot_of_rank, slot_valid), or None when its
    hierarchy was built without bricks (the default, and the device
    builder)."""
    if level.nbr27 is None or level.slot_of_rank is None:
        return None
    return level.nbr27, level.slot_of_rank, level.slot_valid
