"""Synthetic ScanNet-like views drawn from a seed: a frozen copy of the
port's synthetic generator (`_room_surface_points`, the view arrays), cut
before voxelization so that each side voxelizes and builds its kernel maps
itself.

A view is a room-like surface point cloud (floor, walls and furniture
boxes on a jittered grid), its colours, a random 512x512 image with a few
labelled rectangles, per-point 3D labels and mask-space pixel positions.
Everything comes from `rng_for(seed, stream)`, so one seed gives the same
views on every machine and two seeds give different ones.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

VOXEL_SIZE = 0.05  # the generator's grid, as the port's synthetic views use


def rng_for(seed: int, stream: int) -> np.random.RandomState:
    """A numpy RandomState for (seed, stream); any non-negative seed of
    any size (SeedSequence takes big integers)."""
    return np.random.RandomState(np.random.MT19937(np.random.SeedSequence([int(seed), stream])))


def room_surface_points(rng: np.random.RandomState, n: int, room=(4.0, 4.0, 2.5),
                        res: float = 0.05) -> np.ndarray:
    """n points on a synthetic room's floor, walls and furniture boxes, on a
    jittered grid so voxelization yields contiguous surface patches."""
    rx, ry, rz = room
    rects = [
        ((0, 0, 0), (rx, 0, 0), (0, ry, 0)),
        ((0, 0, 0), (rx, 0, 0), (0, 0, rz)),
        ((0, 0, 0), (0, ry, 0), (0, 0, rz)),
        ((0, ry, 0), (rx, 0, 0), (0, 0, rz)),
        ((rx, 0, 0), (0, ry, 0), (0, 0, rz)),
    ]
    for _ in range(rng.randint(2, 5)):
        bx, by = rng.uniform(0.3, 1.2, size=2)
        bz = rng.uniform(0.3, 1.0)
        ox, oy = rng.uniform(0.2, rx - 1.5), rng.uniform(0.2, ry - 1.5)
        rects += [
            ((ox, oy, bz), (bx, 0, 0), (0, by, 0)),
            ((ox, oy, 0), (bx, 0, 0), (0, 0, bz)),
            ((ox, oy, 0), (0, by, 0), (0, 0, bz)),
            ((ox, oy + by, 0), (bx, 0, 0), (0, 0, bz)),
            ((ox + bx, oy, 0), (0, by, 0), (0, 0, bz)),
        ]
    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in rects], np.float64)
    counts = rng.multinomial(n, areas / areas.sum())
    pts = []
    for (o, u, v), c in zip(rects, counts):
        if c == 0:
            continue
        gu = max(1, int(np.linalg.norm(u) / res))
        gv = max(1, int(np.linalg.norm(v) / res))
        iu = rng.randint(0, gu, size=c)
        iv = rng.randint(0, gv, size=c)
        fu = (iu + rng.rand(c)) / gu
        fv = (iv + rng.rand(c)) / gv
        pts.append(np.asarray(o)[None] + fu[:, None] * np.asarray(u)[None]
                   + fv[:, None] * np.asarray(v)[None])
    out = np.concatenate(pts, axis=0)
    return out[rng.permutation(len(out))][:n]


def view_arrays(rng: np.random.RandomState, num_points: int, num_classes: int,
                image_size: Sequence[int], mask_shape: Sequence[int],
                context_length: int, vocab_size: int, rects=(2, 6)) -> Dict[str, np.ndarray]:
    """One view's raw arrays, before voxelization; the 2D labels are
    rng.randint(*rects) labelled rectangles (the 2D targets)."""
    n = num_points
    pts = room_surface_points(rng, n)
    colors = rng.rand(n, 3) * 255
    labels_vox = rng.randint(0, num_classes, size=n)
    labels_3d = rng.randint(0, num_classes + 1, size=n)
    binary = rng.randint(0, 2, size=n).astype(np.float32)
    x_label = rng.randint(10, mask_shape[0] - 10, size=n)
    y_label = rng.randint(10, mask_shape[1] - 10, size=n)
    h, w = image_size
    img = (rng.rand(h, w, 3) * 255).astype(np.float32)
    label_2d = np.full((h, w), num_classes, np.int64)
    for _ in range(rng.randint(*rects)):
        cls = rng.randint(0, num_classes)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        hh = rng.randint(h // 4, max(h // 2, h // 4 + 1))
        ww = rng.randint(w // 4, max(w // 2, w // 4 + 1))
        label_2d[y0:y0 + hh, x0:x0 + ww] = cls
    binary_label_2d = (label_2d[::4, ::4][:128, :128] < num_classes).astype(np.float32)
    return {
        "points": pts, "colors": colors, "labels_vox": labels_vox, "labels_3d": labels_3d,
        "binary_label_3d": binary, "x_label": x_label, "y_label": y_label, "img": img,
        "label_2d": label_2d, "binary_label_2d": binary_label_2d,
        "caption_tokens": caption_tokens(rng, 1, context_length, vocab_size)[0],
    }


def caption_tokens(rng: np.random.RandomState, n: int, context_length: int,
                   vocab_size: int) -> np.ndarray:
    """(n, T) int32 CLIP-style token rows: start token, 3-12 random word
    ids, end token, zero padding (CLIP's start and end ids are the two
    last of the vocabulary)."""
    out = np.zeros((n, context_length), np.int32)
    for i in range(n):
        k = rng.randint(3, min(13, context_length - 1))
        out[i, 0] = vocab_size - 2
        out[i, 1:1 + k] = rng.randint(1, vocab_size - 2, size=k)
        out[i, 1 + k] = vocab_size - 1
    return out


def empty_caption(context_length: int, vocab_size: int) -> np.ndarray:
    """(1, T) the tokens of "": start, end, padding."""
    out = np.zeros((1, context_length), np.int32)
    out[0, 0], out[0, 1] = vocab_size - 2, vocab_size - 1
    return out
