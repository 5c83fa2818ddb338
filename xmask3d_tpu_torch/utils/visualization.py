"""Coloured point-cloud PLY files of per-point labels.

The port's own copy of `xmask3d_tpu/utils/visualization.py` (the
reference's `save_colored_point_cloud`, run/infer.py:268-335), which the
whole-scene CLI's `--save_ply` writes.
"""

from __future__ import annotations

import os
import numpy as np

# 20-class ScanNet-style palette (RGB 0-255)
SCANNET_PALETTE = np.array(
    [
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
        (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
    ],
    dtype=np.uint8,
)


def write_ply(path: str, coords: np.ndarray, colors: np.ndarray) -> None:
    """ASCII PLY with xyz + rgb."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(coords)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for (x, y, z), (r, g, b) in zip(coords, colors):
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {int(r)} {int(g)} {int(b)}\n")


def save_colored_point_cloud(path: str, coords: np.ndarray, labels: np.ndarray) -> None:
    """A per-point-labelled cloud as PLY in the ScanNet palette; the ignore
    label 255 and labels beyond the palette render grey."""
    colors = np.full((len(labels), 3), 128, np.uint8)
    ok = (labels != 255) & (labels < len(SCANNET_PALETTE))
    colors[ok] = SCANNET_PALETTE[labels[ok]]
    write_ply(path, coords, colors)
