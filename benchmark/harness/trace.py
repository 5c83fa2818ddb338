"""Reading a stretch of work under torch.profiler: device time by kernel
name, the device's busy time (the union of its kernel intervals), the idle
gaps labelled by the benchmark's own spans, and device time under chosen
autograd nodes.

The profiler can lose records on the card's machine. Each segment of the
stretch (a scene, a training step) does the same work, so marker kernels
split the timeline into segments and a session whose segments do not all
show the same number of kernels has lost some: it is taken again, and
after `attempts` sessions the reading is None and the run reports no
profiler metric."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

SPANS = ("scene_start", "replay", "readback", "train_step")
MARKER = "erfinv"


def _union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def traced(segments: Sequence[Callable[[], None]], device, attempts: int = 3,
           node_names: Sequence[str] = ()) -> Optional[Dict]:
    """Run the segments under one profiler session; returns wall_s (host
    clock over the segments), busy_s, by_name ({kernel: device s}),
    kernels (a segment), gaps ([[label, s]] longest first) and nodes
    ({node: device s under it}), or None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device=device)
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(50 + 37 * attempt):
                mark.add_(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for seg in segments:
                for _ in range(3):
                    torch.erfinv(mark)
                seg()
            for _ in range(3):
                torch.erfinv(mark)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = prof.events()
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        counts: List[int] = []
        work, after_marker, first, last = [], False, None, None
        for i, (start, stop, name) in enumerate(spans):
            if MARKER in name:
                if not after_marker:
                    counts.append(0)
                after_marker = True
                if first is None:
                    first = i
                last = i
                continue
            after_marker = False
            if counts and first is not None:
                counts[-1] += 1
                work.append((start, stop, name))
        # n segments give n + 1 marker runs: the last run opens no segment
        if counts and counts[-1] == 0:
            counts.pop()
        if len(counts) == len(segments) and min(counts) > 0 and len(set(counts)) == 1:
            break
        print(f"# profiler session {attempt}: kernels a segment {counts}, retaken", flush=True)
    else:
        return None
    by_name: Dict[str, float] = {}
    for start, stop, name in work:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.name in SPANS)
    gaps = []
    merged_end = None
    for start, stop, _ in work:
        if merged_end is not None and start > merged_end:
            mid = (merged_end + start) / 2
            label = next((n for a, b, n in reversed(host) if a <= mid <= b), "other")
            gaps.append([label, (start - merged_end) / 1e6])
        merged_end = stop if merged_end is None else max(merged_end, stop)
    gaps.sort(key=lambda g: -g[1])
    nodes = {n: 0.0 for n in node_names}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("autograd::engine::evaluate"):
            for n in node_names:
                if n in e.name:
                    nodes[n] += e.device_time_total / 1e6
    return {"wall_s": wall_s, "busy_s": _union_us(work) / 1e6, "by_name": by_name,
            "kernels": counts[0], "segments": len(segments), "gaps": gaps[:10], "nodes": nodes}


def breakdown(tr: Dict) -> Dict:
    top = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top], "idle_gaps": tr["gaps"][:10]}


def kernel_seconds(tr: Dict, patterns: Sequence[str]) -> float:
    return sum(s for n, s in tr["by_name"].items() if any(p in n for p in patterns))
