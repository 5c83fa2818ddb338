"""Named spans of the port's host work: the one tracing module.

`span(name)` marks a stretch of host code. Where nothing listens it
returns one shared no-op context: no allocation, no device work, no
synchronisation. Under a `torch.profiler` session it opens
`torch.profiler.record_function(name)`, so the span lands on the
profiler's timeline, the clock of the kernels and of the runtime calls
that launch them. To see them, run a step under the profiler and open its
Chrome trace (chrome://tracing or Perfetto)::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(state, batch, statics, contra_on)
    prof.export_chrome_trace("step.json")

The spans (`xm3d.train.step`, `xm3d.train.forward`, `xm3d.matcher`, ...)
then sit on the calling thread's row above the kernels their code
launched; what the host did while the card idled is the innermost span
open at that instant. `collect()` gathers the spans' host seconds by name
in memory, with no profiler (`engine/infer_cli.py` `run_scene` times its
stages so).

Every name starts with `xm3d.`. Spans nest per thread: a span's parent is
the span open around it on the same thread, and the profiler's events
carry the thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

PREFIX = "xm3d."
_NOOP = contextlib.nullcontext()


class _Local(threading.local):
    collector = None  # this thread's innermost `collect()`, if any


_LOCAL = _Local()


class _Collector:
    """Seconds by span name, each span's own (its nested spans' left
    out), and the open spans' nested seconds, innermost last."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.nested: List[float] = []


def span(name: str):
    """A context marking `name` (`xm3d.`...) on this thread: the shared
    no-op unless a profiler session or a `collect()` of this thread is
    open."""
    collector = _LOCAL.collector
    if collector is not None:
        return _timed(name, collector)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NOOP


@contextlib.contextmanager
def _timed(name: str, collector: _Collector) -> Iterator[None]:
    collector.nested.append(0.0)
    t0 = time.perf_counter()
    try:
        with record_function(name) if _autograd_profiler._is_profiler_enabled else _NOOP:
            yield
    finally:
        dt = time.perf_counter() - t0
        inner = collector.nested.pop()
        if collector.nested:
            collector.nested[-1] += dt
        collector.seconds[name] = collector.seconds.get(name, 0.0) + dt - inner


@contextlib.contextmanager
def collect() -> Iterator[Dict[str, float]]:
    """Gather the host seconds of the spans this thread opens inside, by
    name: each span's own seconds, those of the spans nested in it left
    out, summed over its entries. Yields the dict it fills."""
    outer = _LOCAL.collector
    collector = _LOCAL.collector = _Collector()
    try:
        yield collector.seconds
    finally:
        _LOCAL.collector = outer
