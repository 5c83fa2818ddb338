"""`harness/spans.py` `summarize` on hand-built profiler events: idle and
launches put down to the innermost span, on one segment and on two."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.harness.spans import summarize

MAIN, AUTOGRAD, LOADER = 1, 2, 3


def cpu(name, start, end, thread=MAIN, id=0):
    return SimpleNamespace(name=name, device_type=DeviceType.CPU, thread=thread, id=id,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=name.startswith("xm3d."))


def kernel(name, start, end, id, annotation=False):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA, thread=MAIN, id=id,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def one_step(t0=0.0, id0=100):
    """A step [0, 100) us: forward [10, 50) with the matcher [20, 30) in
    it, backward [50, 90); five kernels, the third launched from
    autograd's thread, the fifth after the step. Returns (events, work)."""
    events = [cpu("xm3d.train.step", t0, t0 + 100), cpu("xm3d.train.forward", t0 + 10, t0 + 50),
              cpu("xm3d.matcher", t0 + 20, t0 + 30), cpu("xm3d.train.backward", t0 + 50, t0 + 90),
              # the card's copy of a span and a torch op whose id is a kernel's: neither counts
              kernel("xm3d.train.forward", t0 + 10, t0 + 50, id=7, annotation=True),
              cpu("aten::mm", t0 + 91, t0 + 93, id=id0 + 2),
              # a loader thread's span across the step's start is not read
              cpu("xm3d.view.hierarchy", t0 - 5, t0 + 20, thread=LOADER)]
    launches = [("cudaLaunchKernel", 4, MAIN), ("cudaLaunchKernel", 21, MAIN),
                ("cuLaunchKernel", 55, AUTOGRAD), ("cudaMemcpyAsync", 92, MAIN),
                ("cudaLaunchKernelExC", 110, MAIN)]
    spans = [(5, 8), (25, 28), (60, 70), (95, 99), (120, 125)]
    work = []
    for k, ((call, at, thread), (a, b)) in enumerate(zip(launches, spans)):
        events.append(cpu(call, t0 + at, t0 + at + 1, thread=thread, id=id0 + k))
        events.append(kernel(f"k{k}", t0 + a, t0 + b, id=id0 + k))
        work.append((t0 + a, t0 + b, f"k{k}"))
    return events, work


def total_idle(work):
    busy = sum(b - a for a, b, _ in work)  # the kernels here never overlap
    return (max(b for _, b, _ in work) - min(a for a, _, _ in work) - busy) / 1e6


def test_idle_goes_to_the_innermost_span_and_outside():
    events, work = one_step()
    s = summarize(events, work)
    assert set(s) == {"xm3d.train.step", "xm3d.train.forward", "xm3d.matcher",
                      "xm3d.train.backward", "outside"}
    us = {n: round(v["idle_s"] * 1e6, 6) for n, v in s.items()}
    # gaps [8, 25), [28, 60), [70, 95), [99, 120)
    assert us == {"xm3d.train.step": 2 + 5 + 1, "xm3d.train.forward": 10 + 20,
                  "xm3d.matcher": 5 + 2, "xm3d.train.backward": 10 + 20, "outside": 20}
    assert sum(v["idle_s"] for v in s.values()) == pytest.approx(total_idle(work), rel=1e-12)


def test_launches_go_to_the_span_open_on_the_calling_thread():
    events, work = one_step()
    s = summarize(events, work)
    got = {n: v["launches"] for n, v in s.items()}
    # the backward's kernel was launched from autograd's thread
    assert got == {"xm3d.train.step": 2, "xm3d.train.forward": 0, "xm3d.matcher": 1,
                   "xm3d.train.backward": 1, "outside": 1}
    assert sum(got.values()) == len(work)


def test_counts_host_and_self_seconds_over_two_segments():
    e1, w1 = one_step()
    e2, w2 = one_step(t0=200.0, id0=200)
    s = summarize(e1 + e2, w1 + w2)
    step, fwd = s["xm3d.train.step"], s["xm3d.train.forward"]
    assert (step["count"], fwd["count"], s["xm3d.matcher"]["count"]) == (2, 2, 2)
    assert step["host_s"] == pytest.approx(2 * 100e-6)
    assert step["self_s"] == pytest.approx(2 * 20e-6)
    assert fwd["self_s"] == pytest.approx(2 * 30e-6)
    assert sum(v["idle_s"] for v in s.values()) == pytest.approx(
        total_idle(w1 + w2), rel=1e-12)
    assert sum(v["launches"] for v in s.values()) == len(w1) + len(w2)
    assert s["xm3d.train.backward"]["launches"] == 2


def test_a_kernel_without_its_launch_call_is_outside():
    events, work = one_step()
    events = [e for e in events if e.name != "cudaMemcpyAsync"]
    s = summarize(events, work)
    assert s["xm3d.train.step"]["launches"] == 1 and s["outside"]["launches"] == 2


def test_no_program_spans_give_an_empty_summary():
    events, work = one_step()
    assert summarize([e for e in events if not e.name.startswith("xm3d.")], work) == {}
