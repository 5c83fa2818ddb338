"""The main path's view time with two GroupNorm implementations, interleaved
in one process on one GPU.

    python -m xmask3d_tpu_torch.tools.groupnorm_ab --parent <checkout> [--views 30]

`<checkout>` is another tree of this repository (for example the parent
commit, unpacked with `git archive`); its `xmask3d_tpu_torch/models/layers.py`
is loaded as a file and its `GroupNorm.forward` becomes the "parent"
variant, the tree that holds this script the "change". The model, weights,
views and kernels are the ones `chip_smoke.py`'s main path uses: B15N4 at
full width in bf16, seeded weights, synthetic views at the bench's
capacities, one view at a time through the serving view body.

Both variants run on the same model, view by view in the order
parent, change, change, parent, ..., so the host's drift falls on both
alike. Per variant it prints the host ms of every view (synchronised before
and after), one profiled view (device kernels launched, device busy ms,
idle share), and the GroupNorm calls of one view replayed alone (host ms
for the view's calls, device ms from CUDA events). The last line is one JSON
object with all of it; it is also written to `--out`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import time

import torch

from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine.builder import build_model, build_statics
from xmask3d_tpu_torch.engine.serve import fresh_vote_state, make_view_body
from xmask3d_tpu_torch.models import layers
from xmask3d_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "scannet", "xmask3d_scannet_B15N4.yaml")


def parent_forward(checkout: str):
    path = os.path.join(checkout, "xmask3d_tpu_torch", "models", "layers.py")
    spec = importlib.util.spec_from_file_location("parent_layers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GroupNorm.forward


def device_profile(fn) -> dict:
    """fn() once under torch.profiler: kernels launched on the device, the
    union of their intervals, and the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return {"kernels": len(spans), "device_busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "device_idle_share": 1 - busy / 1e3 / wall_ms}


def replay(forward, calls, reps: int = 5) -> dict:
    """The recorded GroupNorm calls of one view, run back to back: host ms
    per pass (synchronised at the ends) and device ms from CUDA events."""
    def one_pass():
        for mod, x in calls:
            forward(mod, x)

    one_pass()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        one_pass()
    end.record()
    torch.cuda.synchronize()
    return {"host_ms": (time.perf_counter() - t0) * 1e3 / reps,
            "device_ms": start.elapsed_time(end) / reps,
            "kernels_per_call": device_profile(one_pass)["kernels"] / len(calls)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="another checkout of this repository")
    ap.add_argument("--views", type=int, default=30, help="timed views per variant")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "groupnorm_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("groupnorm_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    variants = {"parent": parent_forward(args.parent), "change": layers.GroupNorm.forward}

    _build.build_all()
    cfg = load_config(CONFIG)
    caps = Capacities(max_points=32768, max_voxels=24576, max_targets=24)
    model = build_model(cfg, seed=0)
    statics = build_statics(model, cfg)
    views = [synthetic_batch(1, caps, seed=100 + i, num_points=20000, image_size=(512, 512),
                             mask_shape=tuple(cfg.mask_shape), context_length=77,
                             vocab_size=49408)
             for i in range(4)]
    view_body = make_view_body(model, cfg)
    mc = model.cfg

    def run_view(i: int) -> None:
        votes, counter = fresh_vote_state(caps.max_points, mc.num_test_classes)
        view_body(views[i % len(views)], statics, votes, counter)

    # the GroupNorm calls of one view, for the replay
    calls = []
    change = variants["change"]

    def recording_forward(mod, x):
        calls.append((mod, x.clone()))
        return change(mod, x)

    layers.GroupNorm.forward = recording_forward
    run_view(0)
    torch.cuda.synchronize()

    result = {"card": card, "views_per_variant": args.views, "groupnorm_calls_per_view": len(calls),
              "view_ms": {k: [] for k in variants}}
    for name, fwd in variants.items():  # one warm view each
        layers.GroupNorm.forward = fwd
        run_view(0)
    torch.cuda.synchronize()
    order = ["parent", "change", "change", "parent"]
    for i in range(2 * args.views):
        name = order[i % 4]
        layers.GroupNorm.forward = variants[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_view(1 + i // 2)
        torch.cuda.synchronize()
        result["view_ms"][name].append((time.perf_counter() - t0) * 1e3)
    for name, fwd in variants.items():
        layers.GroupNorm.forward = fwd
        ms = result["view_ms"][name]
        result[name] = {
            "mean_view_ms": statistics.mean(ms), "median_view_ms": statistics.median(ms),
            "stdev_view_ms": statistics.stdev(ms),
            "profiled_view": device_profile(lambda: run_view(1)),
            "groupnorm_replay": replay(fwd, calls),
        }
    layers.GroupNorm.forward = change
    d = [c - p for p, c in zip(result["view_ms"]["parent"], result["view_ms"]["change"])]
    result["change_minus_parent_ms"] = {
        "mean": statistics.mean(d), "stdev": statistics.stdev(d),
        "stderr": statistics.stdev(d) / len(d) ** 0.5, "pairs": len(d)}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
