"""CUDA graphs for the serving steps: the port's counterpart of `jax.jit`.

A `GraphStep` runs `fn(*args)` from static input buffers. On a CUDA device
it captures `fn` into a `torch.cuda.CUDAGraph` the first time it sees a
shape signature of its arguments: one eager run first (on a side stream; it
loads every kernel variant and module the step uses and fills the device
constants of `device.device_constant`), then the capture. Every later call
copies its arguments into the static buffers on the device and replays the
graph, so a step costs a few copies and one launch on the host instead of a
launch per kernel. A capture or replay that fails raises; nothing falls back
to eager on the card. On the CPU the same buffers are filled the same way
and `fn` runs eagerly on them.

A graph reads the model's parameters where they lie, but a cache built
from them while it was captured (the VAE's layout of K4's weights) stays as
it was then: after writing weights into a model in place, `reset()` its
steps so that the next call captures again.

Arguments are trees of dicts, lists, tuples and dataclasses (the batch's
`SparseHierarchy`) with tensors and plain values at the leaves. The plain
values and each tensor's shape, dtype and device make the signature; one
graph, with its own memory pool, is kept per signature. Outputs are the
graph's own tensors: valid until the next call, which overwrites them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from xmask3d_tpu_torch.device import resolve_device


def flatten(tree) -> Tuple[Hashable, List[torch.Tensor]]:
    """(signature, tensors): the tree's structure with its plain values and
    each tensor's (shape, dtype, device), and its tensors in order."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if torch.is_tensor(x):
            leaves.append(x)
            return ("tensor", tuple(x.shape), x.dtype, x.device)
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return (type(x), tuple((f.name, walk(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)))
        return ("value", x)

    return walk(tree), leaves


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """The tree with `fn` applied to every tensor."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def copy_into(dst, src) -> None:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst`; the two trees must have one signature."""
    d_sig, d_leaves = flatten(dst)
    s_sig, s_leaves = flatten(src)
    if d_sig != s_sig:
        raise ValueError("copy_into: the trees differ in structure, shapes or dtypes")
    for d, s in zip(d_leaves, s_leaves):
        if d is not s:
            d.copy_(s)


class _Captured:
    def __init__(self, inputs, graph, outputs):
        self.inputs, self.graph, self.outputs = inputs, graph, outputs


class GraphStep:
    """`fn(*args)` on static buffers: captured once per signature and
    replayed on CUDA, eager on the CPU (see the module docstring).

    `step(*args)` loads the arguments and runs; `load(*args)` alone copies
    them into the static buffers (capturing first at a new signature),
    `inputs` are those buffers (a caller may write to them between runs, as
    the scene scan writes each view), and `run()` replays."""

    def __init__(self, fn: Callable, device: torch.device):
        self.fn = fn
        self.device = resolve_device(device)
        self._steps: Dict[Hashable, _Captured] = {}
        self._current: Optional[_Captured] = None

    @property
    def inputs(self) -> Tuple:
        return self._current.inputs

    def load(self, *args) -> None:
        sig, leaves = flatten(args)
        if any(t.device != self.device for t in leaves):
            raise ValueError(f"GraphStep: every argument tensor must be on {self.device}")
        cur = self._steps.get(sig)
        if cur is None:
            cur = self._steps[sig] = self._capture(args)
        copy_into(cur.inputs, args)
        self._current = cur

    def run(self):
        cur = self._current
        if cur.graph is None:
            return self.fn(*cur.inputs)
        cur.graph.replay()
        return cur.outputs

    def __call__(self, *args):
        self.load(*args)
        return self.run()

    def _capture(self, args) -> _Captured:
        inputs = tree_map(lambda t: t.clone(), args)
        if self.device.type != "cuda":
            return _Captured(inputs, None, None)
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*inputs)  # warm-up; `load` copies the arguments in again
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # the recorder hook clones tensors: `_build.record` skips it while
        # a stream is capturing
        with torch.cuda.graph(graph):
            outputs = self.fn(*inputs)
        return _Captured(inputs, graph, outputs)

    @property
    def graphs(self) -> int:
        """CUDA graphs held (0 on the CPU, where none is captured)."""
        return sum(c.graph is not None for c in self._steps.values())

    def reset(self) -> None:
        """Drop every graph and its memory pool."""
        self._steps.clear()
        self._current = None
