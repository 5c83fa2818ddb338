"""Tiny cells for the CPU tests: the cells' own files, with the model and
the traffic cut to a size a test run holds (a reduced-width model: tiny
SD towers and CLIP, MinkUNet14A, two decoder layers)."""

from __future__ import annotations

import time

import torch

from benchmark.harness import core

TINY_MODEL = dict(mask_shape=[24, 32], dec_layers=2, pixel_enc_layers=2,
                  arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A")
TINY_TRAFFIC = {
    "scene_scan": dict(points_per_view=400, max_points=512, max_voxels=256, views_per_scene=6,
                       distinct_views=3),
    "train_step": dict(points_per_view=400, max_points=512, max_voxels=256, batch=2,
                       distinct_batches=2, rectangles=[4, 9]),
}


def context(workload: str, seed: int = 2**31 + 5, dtype: str = "float32", seconds: float = 0.0,
            trace: bool = False, bench=core.BENCH):
    """(code, ctx) of a tiny run of `workload` on the CPU."""
    w = core.cell(workload, bench)
    kind = w["traffic_file"]["kind"]
    t0 = time.perf_counter()
    ctx = {"seed": seed, "seconds": seconds, "trace": trace, "device": torch.device("cpu"),
           "tiny": True, "conf": dict(w["config_file"], compute_dtype=dtype, **TINY_MODEL),
           "traffic": dict(w["traffic_file"], **TINY_TRAFFIC[kind]), "limits": w["limits"],
           "t_setup": lambda: time.perf_counter() - t0}
    return core.traffic_code(kind, bench), ctx


def run(workload: str, **kw):
    """(record, checks) of one tiny run."""
    code, ctx = context(workload, **kw)
    record = code.run(ctx)
    return record, code.check(record, ctx), ctx
