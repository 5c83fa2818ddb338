"""Host-side batch prefetch: a pool of threads builds batches ahead of the
step that consumes them.

Counterpart of `xmask3d_tpu/data/prefetch.py`:
- `parallel_map_iterator(fn, args_iter, workers)`: fn over an argument
  iterator by a thread pool, results in order, at most `depth` in flight;
- `prefetch_iterator(it, depth)`: one background thread runs an iterator
  ahead of its consumer, through a bounded queue.

Threads overlap only where the work releases the GIL: numpy's larger
kernels, the native kernel-map builder's foreign calls, file reads. A
worker's exception reaches the consumer at the item it failed on; closing
the iterator (or dropping it) cancels what is still queued and lets the
threads end.

Workers must make no CUDA call: a `cudaHostAlloc` (behind `pin_memory`) or
`cudaMalloc` from another thread while the main thread captures a CUDA
graph invalidates the capture. So they build CPU tensors, and the main
thread pins them and copies them in (`to_device`).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import torch


def parallel_map_iterator(fn: Callable, args_iter: Iterable, workers: int = 2,
                          depth: int = 0) -> Iterator:
    """Yield fn(a) for a in args_iter, in order, with up to `depth` (default
    2 * workers) calls submitted ahead. The arguments are drawn in the
    consumer's thread, in order."""
    if workers < 1:
        raise ValueError(f"workers must be at least 1, got {workers}")
    depth = depth or 2 * workers
    args_iter = iter(args_iter)
    ex = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="prefetch")
    pending: deque = deque()

    def fill():
        while len(pending) < depth:
            try:
                a = next(args_iter)
            except StopIteration:
                return
            pending.append(ex.submit(fn, a))

    try:
        fill()
        while pending:
            out = pending.popleft().result()
            fill()
            yield out
    finally:
        for fut in pending:
            fut.cancel()
        ex.shutdown(wait=False)


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


def prefetch_iterator(it: Iterable, depth: int = 2) -> Iterator:
    """Run `it` in one background thread, at most `depth` items ahead of the
    consumer (production stays sequential, so the iterator's own state is
    kept). An exception raised by `it` is raised to the consumer after the
    items before it."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            put(_Failed(e))
            return
        put(_END)

    t = threading.Thread(target=producer, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item
    finally:
        stop.set()


def to_device(tree, device: torch.device):
    """A batch tree (dicts, lists, tuples, dataclasses) of CPU tensors on
    `device`: on CUDA each tensor is pinned and copied without blocking the
    host, in the calling thread."""
    from xmask3d_tpu_torch.engine.graphs import tree_map

    if device.type == "cpu":
        return tree
    return tree_map(lambda t: t.pin_memory().to(device, non_blocking=True), tree)
