"""Synthetic ScanNet-like views and scenes: own copy of
`xmask3d_tpu/data/synthetic.py` (`synthetic_batch`, `synthetic_scene`).
Room-like surface point clouds, images and 2D labels drawn from a numpy seed
and run through the host pipeline, so the same seed gives the same batch as
the JAX package."""

from __future__ import annotations

from typing import Dict

import numpy as np

from xmask3d_tpu_torch.data.batching import Capacities, ViewSample, collate_views
from xmask3d_tpu_torch.data.tokenizer import build_tokenizer
from xmask3d_tpu_torch.data.voxelizer import Voxelizer


def _room_surface_points(rng: np.random.RandomState, n: int, room=(4.0, 4.0, 2.5),
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


def synthetic_view_sample(
    rng: np.random.RandomState,
    caps: Capacities,
    num_points: int = 2000,
    num_classes: int = 15,
    image_size=(512, 512),
    mask_shape=(240, 320),
    context_length: int = 77,
    vocab_size: int = 49408,
) -> ViewSample:
    n = num_points
    pts = _room_surface_points(rng, n)
    colors = rng.rand(n, 3) * 255
    coords, feats, _, inds_rec = Voxelizer(voxel_size=0.05).voxelize(
        pts, colors, rng.randint(0, num_classes, size=n)
    )
    coords = coords[: caps.max_voxels]
    labels_3d = rng.randint(0, num_classes + 1, size=n)
    binary = rng.randint(0, 2, size=n).astype(np.float32)
    x_label = rng.randint(10, mask_shape[0] - 10, size=n)
    y_label = rng.randint(10, mask_shape[1] - 10, size=n)
    h, w = image_size
    img = (rng.rand(h, w, 3) * 255).astype(np.float32)
    label_2d = np.full((h, w), num_classes, np.int64)
    for _ in range(rng.randint(2, 6)):
        cls = rng.randint(0, num_classes)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        hh = rng.randint(h // 4, max(h // 2, h // 4 + 1))
        ww = rng.randint(w // 4, max(w // 2, w // 4 + 1))
        label_2d[y0 : y0 + hh, x0 : x0 + ww] = cls
    binary_label_2d = (label_2d[::4, ::4][:128, :128] < num_classes).astype(np.float32)
    tok = build_tokenizer(vocab_size=vocab_size, context_length=context_length)
    return ViewSample(
        voxel_coords=coords,
        voxel_feats=(feats[: caps.max_voxels] / 127.5 - 1.0).astype(np.float32),
        inds_reconstruct=np.clip(inds_rec, 0, caps.max_voxels - 1),
        labels_3d=labels_3d,
        binary_label_3d=binary,
        x_label=x_label,
        y_label=y_label,
        img=img,
        label_2d=label_2d,
        binary_label_2d=binary_label_2d,
        caption_tokens=tok(["a room with chairs and a table"])[0],
    )


def synthetic_scene(
    caps: Capacities,
    seed: int = 0,
    num_points: int = 8000,
    num_views: int = 4,
    num_classes: int = 15,
    image_size=(64, 64),
    mask_shape=(24, 32),
    context_length: int = 16,
    vocab_size: int = 512,
) -> Dict:
    """A synthetic scene with consistent multi-view structure: one point
    cloud and views whose visible subsets are contiguous bands of it, the
    layout of `ScanNetSceneViews.scene` (numpy; same arrays as the JAX
    package's `synthetic_scene` from the same seed)."""
    rng = np.random.RandomState(seed)
    pts = _room_surface_points(rng, num_points)
    colors = rng.rand(num_points, 3) * 255
    labels = rng.randint(0, num_classes, size=num_points).astype(np.int64)
    tok = build_tokenizer(vocab_size=vocab_size, context_length=context_length)
    views = []
    for _ in range(num_views):
        d = rng.randn(3)
        d /= np.linalg.norm(d)
        proj = pts @ d
        lo = np.quantile(proj, rng.uniform(0.0, 0.35))
        hi = np.quantile(proj, rng.uniform(0.6, 1.0))
        visible = (proj >= lo) & (proj <= hi)
        n_vis = int(visible.sum())
        if n_vis < 50:
            visible = np.ones(num_points, bool)
            n_vis = num_points
        idx = np.where(visible)[0]
        coords, feats, _, inds_rec = Voxelizer(voxel_size=0.05).voxelize(
            pts[idx], colors[idx], labels[idx]
        )
        coords = coords[: caps.max_voxels]
        h, w = image_size
        img = (rng.rand(h, w, 3) * 255).astype(np.float32)
        label_2d = np.full((h, w), num_classes, np.int64)
        for _ in range(rng.randint(2, 5)):
            cls = rng.randint(0, num_classes)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            label_2d[y0 : y0 + h // 3, x0 : x0 + w // 3] = cls
        binary_2d = (label_2d[:: max(1, h // 128), :: max(1, w // 128)][:128, :128]
                     < num_classes).astype(np.float32)
        sample = ViewSample(
            voxel_coords=coords,
            voxel_feats=(feats[: caps.max_voxels] / 127.5 - 1.0).astype(np.float32),
            inds_reconstruct=np.clip(inds_rec, 0, caps.max_voxels - 1),
            labels_3d=labels[idx],
            binary_label_3d=rng.randint(0, 2, size=n_vis).astype(np.float32),
            x_label=rng.randint(0, mask_shape[0], size=n_vis),
            y_label=rng.randint(0, mask_shape[1], size=n_vis),
            img=img,
            label_2d=label_2d,
            binary_label_2d=binary_2d,
            caption_tokens=tok(["a synthetic room"])[0],
        )
        views.append({"sample": sample, "visible": visible})
    return {"name": f"synthetic_{seed}", "coords": pts, "colors": colors, "labels": labels,
            "views": views}


def synthetic_batch(
    batch_size: int,
    caps: Capacities,
    seed: int = 0,
    num_points: int = 2000,
    num_classes: int = 15,
    image_size=(512, 512),
    mask_shape=(240, 320),
    context_length: int = 77,
    vocab_size: int = 49408,
    device=None,
    device_hierarchy: bool = False,
) -> Dict:
    """`batch_size` synthetic views from `seed`, collated on `device`; with
    `device_hierarchy` the batch ships voxel coords and counts in place of
    the hierarchy (`collate_views`)."""
    rng = np.random.RandomState(seed)
    samples = [
        synthetic_view_sample(rng, caps, num_points, num_classes, image_size,
                              mask_shape, context_length, vocab_size)
        for _ in range(batch_size)
    ]
    return collate_views(samples, caps, device=device, device_hierarchy=device_hierarchy)
