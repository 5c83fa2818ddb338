"""Point-cloud augmentations (host-side numpy): own copy of
`xmask3d_tpu/data/augmentation.py`.

Chromatic transforms, hue/saturation jitter, horizontal flip, elastic
distortion, and Compose.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *args):
        for t in self.transforms:
            args = t(*args)
        return args


class ChromaticTranslation:
    """Add random color offset (+- 255 * trans_range_ratio)."""

    def __init__(self, trans_range_ratio=0.1, rng=None):
        self.trans_range_ratio = trans_range_ratio
        self.rng = rng or np.random.RandomState()

    def __call__(self, coords, feats, labels):
        if self.rng.rand() < 0.95:
            tr = (self.rng.rand(1, 3) - 0.5) * 255 * 2 * self.trans_range_ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticAutoContrast:
    def __init__(self, randomize_blend_factor=True, blend_factor=0.5, rng=None):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor
        self.rng = rng or np.random.RandomState()

    def __call__(self, coords, feats, labels):
        if self.rng.rand() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast_feats = (feats[:, :3] - lo) * scale
            blend = self.rng.rand() if self.randomize_blend_factor else self.blend_factor
            feats = feats.copy()
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast_feats
        return coords, feats, labels


class ChromaticJitter:
    def __init__(self, std=0.01, rng=None):
        self.std = std
        self.rng = rng or np.random.RandomState()

    def __call__(self, coords, feats, labels):
        if self.rng.rand() < 0.95:
            noise = self.rng.randn(feats.shape[0], 3) * 255 * self.std
            feats = feats.copy()
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


class HueSaturationTranslation:
    @staticmethod
    def rgb_to_hsv(rgb):
        rgb = rgb.astype("float")
        hsv = np.zeros_like(rgb)
        maxc = rgb.max(-1)
        minc = rgb.min(-1)
        hsv[..., 2] = maxc
        mask = maxc != minc
        hsv[mask, 1] = (maxc - minc)[mask] / maxc[mask]
        rc = np.zeros_like(maxc)
        gc = np.zeros_like(maxc)
        bc = np.zeros_like(maxc)
        denom = np.maximum(maxc - minc, 1e-8)
        rc[mask] = (maxc - rgb[..., 0])[mask] / denom[mask]
        gc[mask] = (maxc - rgb[..., 1])[mask] / denom[mask]
        bc[mask] = (maxc - rgb[..., 2])[mask] / denom[mask]
        hsv[..., 0] = np.select(
            [rgb[..., 0] == maxc, rgb[..., 1] == maxc],
            [bc - gc, 2.0 + rc - bc],
            default=4.0 + gc - rc,
        )
        hsv[..., 0] = (hsv[..., 0] / 6.0) % 1.0
        return hsv

    @staticmethod
    def hsv_to_rgb(hsv):
        rgb = np.empty_like(hsv)
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = (h * 6.0).astype("uint8")
        f = (h * 6.0) - i
        p = v * (1.0 - s)
        q = v * (1.0 - s * f)
        t = v * (1.0 - s * (1.0 - f))
        i = i % 6
        conds = [i == k for k in range(6)]
        rgb[..., 0] = np.select(conds, [v, q, p, p, t, v])
        rgb[..., 1] = np.select(conds, [t, v, v, q, p, p])
        rgb[..., 2] = np.select(conds, [p, p, t, v, v, q])
        return rgb.astype("uint8")

    def __init__(self, hue_max=0.5, saturation_max=0.2, rng=None):
        self.hue_max = hue_max
        self.saturation_max = saturation_max
        self.rng = rng or np.random.RandomState()

    def __call__(self, coords, feats, labels):
        hsv = self.rgb_to_hsv(feats[:, :3])
        hue = (self.rng.rand() - 0.5) * 2 * self.hue_max
        sat = 1 + (self.rng.rand() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat * hsv[..., 1], 0, 1)
        feats = feats.copy()
        feats[:, :3] = np.clip(self.hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


class RandomHorizontalFlip:
    def __init__(self, upright_axis="z", is_temporal=False, rng=None):
        self.is_temporal = is_temporal
        self.d = 4 if is_temporal else 3
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = set(range(self.d)) - {self.upright_axis}
        self.rng = rng or np.random.RandomState()

    def __call__(self, coords, feats, labels):
        if self.rng.rand() < 0.95:
            for ax in self.horz_axes:
                if self.rng.rand() < 0.5:
                    coords = coords.copy()
                    coords[:, ax] = coords[:, ax].max() - coords[:, ax]
        return coords, feats, labels


class ElasticDistortion:
    """Gaussian-blurred random displacement grid, trilinearly interpolated
    (reference augmentation.py:135-181)."""

    def __init__(self, distortion_params=((0.2, 0.4), (0.8, 1.6)), rng=None):
        self.distortion_params = distortion_params
        self.rng = rng or np.random.RandomState()

    def elastic_distortion(self, coords, granularity, magnitude):
        blurx = np.ones((3, 1, 1, 1)).astype("float32") / 3
        blury = np.ones((1, 3, 1, 1)).astype("float32") / 3
        blurz = np.ones((1, 1, 3, 1)).astype("float32") / 3
        coords_min = coords.min(0)

        noise_dim = ((coords - coords_min).max(0) // granularity).astype(int) + 3
        noise = self.rng.randn(*noise_dim, 3).astype(np.float32)
        for _ in range(2):
            noise = scipy.ndimage.convolve(noise, blurx, mode="constant", cval=0)
            noise = scipy.ndimage.convolve(noise, blury, mode="constant", cval=0)
            noise = scipy.ndimage.convolve(noise, blurz, mode="constant", cval=0)
        ax = [
            np.linspace(d_min, d_max, d)
            for d_min, d_max, d in zip(
                coords_min - granularity,
                coords_min + granularity * (noise_dim - 2),
                noise_dim,
            )
        ]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0
        )
        return coords + interp(coords) * magnitude

    def __call__(self, coords, feats=None, labels=None):
        if self.distortion_params is not None and self.rng.rand() < 0.95:
            for granularity, magnitude in self.distortion_params:
                coords = self.elastic_distortion(coords, granularity, magnitude)
        if feats is None and labels is None:
            return coords
        return coords, feats, labels
