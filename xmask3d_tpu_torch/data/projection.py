"""3D point -> 2D pixel projection with occlusion testing (host-side numpy):
own copy of `xmask3d_tpu/data/projection.py`.

Pinhole projection of scene points into a posed depth
frame, visibility threshold |depth - z| <= vis_thres * depth, and a boundary
cut of 10 px. ScanNet intrinsics fx=fy=577.870605 rescaled 640x480 -> 320x240.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_intrinsic(fx: float, fy: float, mx: float, my: float) -> np.ndarray:
    intrinsic = np.eye(4)
    intrinsic[0][0] = fx
    intrinsic[1][1] = fy
    intrinsic[0][2] = mx
    intrinsic[1][2] = my
    return intrinsic


def adjust_intrinsic(intrinsic, intrinsic_image_dim, image_dim) -> np.ndarray:
    if intrinsic_image_dim == image_dim:
        return intrinsic
    resize_width = int(
        np.floor(image_dim[1] * intrinsic_image_dim[0] / intrinsic_image_dim[1])
    )
    out = intrinsic.copy()
    out[0, 0] *= resize_width / intrinsic_image_dim[0]
    out[1, 1] *= image_dim[1] / intrinsic_image_dim[1]
    out[0, 2] *= (image_dim[0] - 1) / (intrinsic_image_dim[0] - 1)
    out[1, 2] *= (image_dim[1] - 1) / (intrinsic_image_dim[1] - 1)
    return out


class PointCloudToImageMapper:
    def __init__(
        self,
        image_dim=(320, 240),
        visibility_threshold: float = 0.25,
        cut_bound: int = 10,
        intrinsics: Optional[np.ndarray] = None,
    ):
        self.image_dim = image_dim
        self.vis_thres = visibility_threshold
        self.cut_bound = cut_bound
        self.intrinsics = intrinsics

    def compute_mapping(
        self,
        camera_to_world: np.ndarray,
        coords: np.ndarray,
        depth: Optional[np.ndarray] = None,
        intrinsic: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Returns (N, 3) int array of (pixel_y, pixel_x, visible)."""
        if self.intrinsics is not None:
            intrinsic = self.intrinsics
        n = coords.shape[0]
        mapping = np.zeros((n, 3), dtype=int)

        world_to_camera = np.linalg.inv(camera_to_world)
        homo = np.concatenate([coords, np.ones((n, 1))], axis=1).T
        p = world_to_camera @ homo

        safe_z = p[2].copy()
        safe_z[np.abs(safe_z) < 1e-8] = 1.0
        px = (p[0] * intrinsic[0][0]) / safe_z + intrinsic[0][2]
        py = (p[1] * intrinsic[1][1]) / safe_z + intrinsic[1][2]
        pi_x = np.round(px).astype(int)
        pi_y = np.round(py).astype(int)

        inside = (
            (p[2] > 0)
            & (pi_x >= self.cut_bound)
            & (pi_y >= self.cut_bound)
            & (pi_x < self.image_dim[0] - self.cut_bound)
            & (pi_y < self.image_dim[1] - self.cut_bound)
        )

        if depth is not None and inside.any():
            vy, vx, vz = pi_y[inside], pi_x[inside], p[2][inside]
            ok = (vy >= 0) & (vy < depth.shape[0]) & (vx >= 0) & (vx < depth.shape[1])
            visible = np.zeros_like(inside)
            if ok.any():
                dy, dx, dz = vy[ok], vx[ok], vz[ok]
                depth_vals = depth[dy, dx]
                close = np.abs(depth_vals - dz) <= self.vis_thres * depth_vals
                idx = np.where(inside)[0][ok]
                visible[idx[close]] = True
            inside = visible

        mapping[inside, 0] = pi_y[inside]
        mapping[inside, 1] = pi_x[inside]
        mapping[inside, 2] = 1
        return mapping


def get_scannet_mapper() -> PointCloudToImageMapper:
    """Default ScanNet mapper (reference mapping_util.py:10-39)."""
    img_dim = (320, 240)
    intrinsic = make_intrinsic(fx=577.870605, fy=577.870605, mx=319.5, my=239.5)
    intrinsic = adjust_intrinsic(
        intrinsic, intrinsic_image_dim=[640, 480], image_dim=img_dim
    )
    return PointCloudToImageMapper(
        image_dim=img_dim,
        visibility_threshold=0.25,
        cut_bound=10,
        intrinsics=intrinsic,
    )
