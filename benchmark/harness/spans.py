"""The program's own spans in a traced stretch: where the card idled and
which stage launched each kernel, by span name.

The port marks its stages with spans named `xm3d.<...>`
(`torch.profiler.record_function` while a profiler runs). They are matched
here by that literal prefix, so this file imports nothing of the port, and
a program without such spans gives an empty summary.

A segment is one outermost `xm3d.` span (a training step's
`xm3d.train.step`); only the `xm3d.` spans of the thread that opens them
are read (a loader thread's are not), and at each instant of a segment
the innermost of them that is open is its owner. Then:

- each idle instant between the first and the last kernel of the stretch
  goes to the span that owns it, so the shares are exclusive;
- each kernel goes to the span that owned the instant at which the
  runtime or driver call that launched it began, whichever thread made
  that call (autograd launches the backward's kernels from its own
  thread while the calling thread waits inside its backward span). The
  profiler gives a kernel and its launch call one correlation id;
- idle under no span, and kernels launched under none or whose launch
  call the profiler did not record, go to `outside`.

Times are the profiler's: microseconds on one clock for the host's events
and the card's kernels.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Sequence, Tuple

PREFIX = "xm3d."
# a runtime or driver call that may launch work: cudaLaunchKernel,
# cudaLaunchKernelExC, cuLaunchKernel, cudaMemcpyAsync, cudaMemsetAsync, ...
LAUNCH = re.compile(r"^cu(da)?[A-Z]")

Piece = Tuple[float, float, str]  # [start, end) us owned by a span name


def _segments(spans: List[Tuple[float, float, str, int]]) -> List[List[Tuple[float, float, str]]]:
    """The spans of the thread whose outermost spans cover the most time
    (the one that runs the steps; a loader thread's spans are left out),
    by segment: an outermost span, then the spans that start inside it,
    by start (the longer first on a tie)."""
    by_thread: Dict[int, List[Tuple[float, float, str]]] = {}
    for start, end, name, thread in spans:
        by_thread.setdefault(thread, []).append((start, end, name))
    best, best_cover = [], -1.0
    for rows in by_thread.values():
        rows.sort(key=lambda r: (r[0], -r[1]))
        segments, end = [], float("-inf")
        for row in rows:
            if row[0] >= end:
                segments.append([])
                end = row[1]
            segments[-1].append(row)
        cover = sum(seg[0][1] - seg[0][0] for seg in segments)
        if cover > best_cover:
            best, best_cover = segments, cover
    return best


def _pieces(segment: List[Tuple[float, float, str]]) -> List[Piece]:
    """The segment's time cut where a span opens or closes, each piece
    owned by the innermost span open over it. A span that outlasts its
    parent (rounding) is cut at the parent's end."""
    pieces: List[Piece] = []
    stack: List[Tuple[float, str]] = []  # (end, name), innermost last
    t = segment[0][0]
    for start, end, name in segment:
        while stack and stack[-1][0] <= start:
            top_end, top = stack.pop()
            pieces.append((t, top_end, top))
            t = top_end
        if stack:
            end = min(end, stack[-1][0])
            pieces.append((t, start, stack[-1][1]))
        t = start
        stack.append((end, name))
    while stack:
        top_end, top = stack.pop()
        pieces.append((t, top_end, top))
        t = top_end
    return [p for p in pieces if p[1] > p[0]]


def _idle(work: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float]]:
    """The gaps between the union of the kernels' intervals, from the
    first kernel's start to the last one's end."""
    gaps, end = [], None
    for start, stop, _ in sorted(work):
        if end is not None and start > end:
            gaps.append((end, start))
        end = stop if end is None else max(end, stop)
    return gaps


def summarize(events, work: Sequence[Tuple[float, float, str]]) -> Dict[str, Dict]:
    """{span name: {"count", "host_s", "self_s", "idle_s", "launches"}}
    summed over the segments, plus {"outside": {"idle_s", "launches"}};
    empty where the events hold no `xm3d.` span. `events` are the
    profiler's (`prof.events()`), `work` the stretch's kernels as
    (start us, end us, name), each counted once. host_s is a span's
    duration, self_s the part of it no nested span covers."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, e.name, e.thread) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
    if not spans:
        return {}
    out: Dict[str, Dict] = {}
    pieces: List[Piece] = []
    for segment in _segments(spans):
        for start, end, name in segment:
            row = out.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0, "idle_s": 0.0,
                                        "launches": 0})
            row["count"] += 1
            row["host_s"] += (end - start) / 1e6
        pieces += _pieces(segment)
    pieces.sort()
    outside = {"idle_s": 0.0, "launches": 0}
    for start, end, name in pieces:
        out[name]["self_s"] += (end - start) / 1e6

    i = 0
    for a, b in _idle(work):
        owned = 0.0
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            part = min(b, pieces[j][1]) - max(a, pieces[j][0])
            out[pieces[j][2]]["idle_s"] += part / 1e6
            owned += part
            j += 1
        outside["idle_s"] += (b - a - owned) / 1e6

    # a kernel and the call that launched it share the profiler's id
    ids: Dict[Tuple[float, float, str], List[int]] = {}
    launched_at: Dict[int, float] = {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            if LAUNCH.match(e.name):
                launched_at[e.id] = e.time_range.start
        elif not getattr(e, "is_user_annotation", False):
            ids.setdefault((e.time_range.start, e.time_range.end, e.name), []).append(e.id)
    starts = [p[0] for p in pieces]
    for kernel in work:
        t = launched_at.get(ids[kernel].pop()) if ids.get(kernel) else None
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0 and t < pieces[k][1]:
            out[pieces[k][2]]["launches"] += 1
        else:
            outside["launches"] += 1
    out["outside"] = outside
    return out
