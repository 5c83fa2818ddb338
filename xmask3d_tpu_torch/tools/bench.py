"""Scene-inference throughput of the port on the GPU, in scenes/s.

    python -m xmask3d_tpu_torch.tools.bench

Counterpart of the JAX package's `bench.py` (`main`), without its probe
and retry of a remote TPU backend. The full XMask3D eval pipeline (SD v1
backbone at 512x512, MinkUNet34C/18A, the Mask2Former head, MaskCLIP ViT-L,
ensemble and routing and the per-point votes on the device) on synthetic
ScanNet-like views, by the reference's inference protocol: batch one view,
30 views a scene, votes per scene point. Weights are random, drawn from a
seed, and stored in bf16 (the config's compute dtype). The last line of
standard output is one JSON object, {"metric", "value", "unit",
"vs_baseline"}; lines before it start with "#".

Modes, by environment variable (the JAX bench's names):
- BENCH_SIZE: "full" (default; 32768 points, 24576 voxels, 512x512 image,
  77 tokens, 20000-point views), "worst" (the config's 65536 / 49152
  capacities, 60000-point views) or "tiny" (a reduced-width model).
- BENCH_SCAN_VIEWS=1 (default): each scene's views go through
  `make_scene_scan_step`, the view body captured once as a CUDA graph and
  replayed a view at a time with the votes on the device; 0 calls the
  captured view body once a view from Python.
- BENCH_DISTINCT_VIEWS (default 6): the distinct views, built before the
  timed window and cycled through the scene's 30.
- BENCH_PIPELINE_SCENES=1 (default): every scene is launched before the
  first scene's votes are read back; 0 reads each scene's back before the
  next starts and prints its time.
- BENCH_DEVICE_HIER=1: views ship voxel coords and the hierarchy is built
  on the device, inside the captured view (`ops/hierarchy_device.py`).
- BENCH_VIEW_BATCH=B (default 1): B views a forward, drawn together by
  `synthetic_batch(B, ...)`; a scene takes max(1, 30 // B) steps, the
  distinct views are staged B at a time (BENCH_DISTINCT_VIEWS steps of B),
  and the view body is captured at B views. Every mode takes it.
- BENCH_SCENE_REUSE=1: one 3D pass a scene at BENCH_SCENE_FACTOR (default
  4) times the view's capacities, the views' 2D passes on its outputs
  (`engine/scene_reuse.py`); metric `scene_inference_throughput_reuse`.
- BENCH_BF16_PARAMS=1 (default): the serving weight cast of
  `engine/infer_cli.py` `cast_params_bf16`. The port stores the parameters
  in the compute dtype (bf16), so it casts none; 0 skips it.
- BENCH_INCLUDE_HOST=1: every view is built on the host inside the timed
  window (`synthetic_batch` at seeds 1000 on: voxelization, images, the
  native kernel-map build), by BENCH_HOST_WORKERS threads (default 4,
  `data/prefetch.py`) that make CPU tensors, and pinned and copied in
  without blocking by this thread; metric `scene_inference_throughput_e2e`.

`vs_baseline` divides by 0.15 scenes/s, the JAX bench's denominator: an
estimate for an A100 in fp32 (~0.2 s a view of SD UNet and VAE plus the 3D
UNets, 30 views a scene), not a measurement; the reference publishes no
throughput.

It runs on the GPU and raises without one; `main(device="cpu", ...)` runs
the same steps eagerly on the CPU with the plain versions of the kernels,
for tests.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.prefetch import parallel_map_iterator, to_device
from xmask3d_tpu_torch.data.synthetic import synthetic_batch, synthetic_scene
from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.engine.builder import build_model, build_statics
from xmask3d_tpu_torch.engine.infer_cli import cast_params_bf16
from xmask3d_tpu_torch.engine.scene_reuse import (
    make_scene_3d_step,
    scene_3d_batch,
    scene_caps_from_view_caps,
)
from xmask3d_tpu_torch.engine.serve import fresh_vote_state, make_scene_scan_step, stack_views

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "scannet", "xmask3d_scannet_B15N4.yaml")
A100_BASELINE_SCENES_PER_SEC = 0.15  # an estimate, see the module docstring
VIEWS_PER_SCENE = 30
NUM_SCENES = 3

# BENCH_SIZE -> (capacities, image side, context length, vocabulary, points a view)
SIZES = {
    "tiny": (Capacities(max_points=512, max_voxels=256, max_targets=8), 64, 16, 512, 400),
    "full": (Capacities(max_points=32768, max_voxels=24576, max_targets=24), 512, 77, 49408,
             20000),
    "worst": (Capacities(max_points=65536, max_voxels=49152, max_targets=24), 512, 77, 49408,
              60000),
}


def _flag(name: str, default: str) -> bool:
    return os.environ.get(name, default) == "1"


def main(device=None, num_scenes: int = NUM_SCENES, views_per_scene: int = VIEWS_PER_SCENE
         ) -> Tuple[Dict, np.ndarray]:
    """Run the mode the environment selects; prints its lines and returns
    (the result line as a dict, the last scene's vote table on the host)."""
    dev = resolve_device(device)
    size = os.environ.get("BENCH_SIZE", "full")
    if size not in SIZES:
        raise ValueError(f"BENCH_SIZE must be one of {sorted(SIZES)}, got {size!r}")
    caps, image, ctx, vocab, npts = SIZES[size]
    tiny = size == "tiny"
    cfg = load_config(CONFIG)
    if tiny:
        cfg.mask_shape = [24, 32]
    device_hier = _flag("BENCH_DEVICE_HIER", "0")
    scene_reuse = _flag("BENCH_SCENE_REUSE", "0")
    scan_views = _flag("BENCH_SCAN_VIEWS", "1")
    include_host = _flag("BENCH_INCLUDE_HOST", "0")
    view_batch = int(os.environ.get("BENCH_VIEW_BATCH", "1"))
    if view_batch < 1:
        raise ValueError(f"BENCH_VIEW_BATCH must be >= 1, got {view_batch}")
    steps_per_scene = max(1, views_per_scene // view_batch)
    view_kw = dict(num_points=npts, image_size=(image, image), mask_shape=tuple(cfg.mask_shape),
                   context_length=ctx, vocab_size=vocab, device_hierarchy=device_hier)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    model = build_model(cfg, tiny=tiny, seed=0, device=dev)
    if _flag("BENCH_BF16_PARAMS", "1"):
        print(f"# bf16 params: {cast_params_bf16(model)} fp32 parameters cast", flush=True)
    statics = build_statics(model, cfg, device=dev)
    n_classes = model.cfg.num_test_classes
    scan = make_scene_scan_step(model, cfg, scene_reuse=scene_reuse, device=dev)
    view_step = scan.step  # the captured view body, shared with the per-view modes
    scene = {}
    if scene_reuse:
        scene_caps = scene_caps_from_view_caps(
            caps, factor=int(os.environ.get("BENCH_SCENE_FACTOR", "4")))
        sc = synthetic_scene(caps, seed=7, num_points=min(scene_caps.max_points, 8 * npts),
                             num_views=1, num_classes=cfg.classes, image_size=(image, image),
                             mask_shape=tuple(cfg.mask_shape), context_length=ctx,
                             vocab_size=vocab)
        scene_batch = scene_3d_batch(sc["coords"], sc["colors"], scene_caps, voxel_size=0.05,
                                     device=dev)
        step_3d = make_scene_3d_step(model)

    def scene_begin() -> Tuple:
        """A fresh vote state, and in scene-reuse mode the scene's one 3D
        pass, whose outputs every view of the scene reads."""
        if scene_reuse:
            scene["s3"] = step_3d(scene_batch)
        return fresh_vote_state(caps.max_points, n_classes, device=dev)

    def extra() -> Tuple:
        return (scene["s3"],) if scene_reuse else ()

    def step_view(batch, votes):
        return view_step(batch, statics, *votes, *extra())

    if include_host:
        line, votes = _measure_host(dev, caps, view_kw, num_scenes, steps_per_scene,
                                    view_batch, scene_begin, step_view, sync)
    else:
        n_distinct = int(os.environ.get("BENCH_DISTINCT_VIEWS", "6"))
        views = [synthetic_batch(view_batch, caps, seed=100 + v, device=dev, **view_kw)
                 for v in range(0, min(views_per_scene, n_distinct * view_batch), view_batch)]
        stacked = stack_views(views) if scan_views else None
        idxseq = torch.arange(steps_per_scene, dtype=torch.int32) % len(views)

        def run_scene():
            votes = scene_begin()
            if scan_views:
                return scan(stacked, idxseq, statics, *votes, *extra())
            for i in idxseq.tolist():
                votes = step_view(views[i], votes)
            return votes

        rate, votes = _measure(run_scene, num_scenes, _flag("BENCH_PIPELINE_SCENES", "1"), sync)
        line = _line("scene_inference_throughput_reuse" if scene_reuse
                     else "scene_inference_throughput", rate)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu, the kernels' plain versions (not a device measurement)"
    print(f"# device: {where}", flush=True)
    print(json.dumps(line), flush=True)
    return line, votes


def _line(metric: str, rate: float) -> Dict:
    return {"metric": metric, "value": round(rate, 5), "unit": "scenes/sec/chip",
            "vs_baseline": round(rate / A100_BASELINE_SCENES_PER_SEC, 3)}


def _measure(run_scene, num_scenes: int, pipelined: bool, sync) -> Tuple[float, np.ndarray]:
    """Scenes/s over `num_scenes` runs of `run_scene` after an untimed one
    (captures, allocator); every scene's voted prediction reaches the host
    inside the timed window."""
    votes = run_scene()
    votes[0].argmax(1).cpu()
    sync()
    t0 = time.perf_counter()
    if pipelined:
        # scenes are independent (fresh votes each), so all are launched
        # before the first is read back
        preds = []
        for _ in range(num_scenes):
            votes = run_scene()
            preds.append(votes[0].argmax(1))
        for p in preds:
            p.cpu()
    else:
        for s in range(num_scenes):
            ts = time.perf_counter()
            votes = run_scene()
            votes[0].argmax(1).cpu()
            print(f"# scene {s}: {time.perf_counter() - ts:.3f}s", flush=True)
    dt = time.perf_counter() - t0
    print(f"# {num_scenes} scenes in {dt:.3f}s", flush=True)
    return num_scenes / dt, votes[0].cpu().numpy()


def _measure_host(dev, caps, view_kw, num_scenes: int, steps_per_scene: int, view_batch: int,
                  scene_begin, step_view, sync) -> Tuple[Dict, np.ndarray]:
    """BENCH_INCLUDE_HOST: each step's `view_batch` views built by the
    worker pool inside the timed window, pinned and copied in here, then
    its captured step."""
    workers = int(os.environ.get("BENCH_HOST_WORKERS", "4"))
    # the view body is captured before the pool starts
    votes = step_view(synthetic_batch(view_batch, caps, seed=0, device=dev, **view_kw),
                      scene_begin())
    votes[0].argmax(1).cpu()

    def build_view(seed: int):
        return synthetic_batch(view_batch, caps, seed=seed, device="cpu", **view_kw)

    built = parallel_map_iterator(build_view, itertools.count(1000), workers)

    def host_scene():
        votes = scene_begin()
        for _ in range(steps_per_scene):
            votes = step_view(to_device(next(built), dev), votes)
        return votes

    try:
        votes = host_scene()  # untimed: fills the prefetch window
        votes[0].argmax(1).cpu()
        sync()
        t0 = time.perf_counter()
        for s in range(num_scenes):
            ts = time.perf_counter()
            votes = host_scene()
            votes[0].argmax(1).cpu()
            print(f"# scene {s} (host incl.): {time.perf_counter() - ts:.3f}s", flush=True)
        rate = num_scenes / (time.perf_counter() - t0)
    finally:
        built.close()
    return _line("scene_inference_throughput_e2e", rate), votes[0].cpu().numpy()


if __name__ == "__main__":
    main()
