"""What the reference's calls at the cell's inputs need: each kernel's
bytes and operations (`kernels/*.py`), and the whole forward's operations
(`torch.utils.flop_counter` over the dense ops, with the sparse convs
counted over the live pairs of their kernel maps)."""

from __future__ import annotations

from typing import Dict

from benchmark.harness.core import BENCH, load_module
from benchmark.kernels.peaks import HBM_BYTES_PER_S


def kernel_modules() -> Dict:
    """{kernel name: module} of every kernels/k*.py."""
    return {p.stem: load_module(p, f"benchmark_kernel_{p.stem}")
            for p in sorted((BENCH / "kernels").glob("k*.py"))}


class Work:
    """A sink for `reference/ops/record.py`: adds up, over the calls it
    sees, each kernel's least time on the card (`bound_s`, the larger of
    bytes over the memory rate and operations over the peak of their
    type, a call at a time) and the dense counter's correction to live
    pairs (`flops_fix`)."""

    def __init__(self, itemsize: int):
        self.itemsize = itemsize
        self.kernels = kernel_modules()
        self.by_op = {m.OP: name for name, m in self.kernels.items()}
        self.bound_s = {name: 0.0 for name in self.kernels}
        self.calls = {name: 0 for name in self.kernels}
        self.flops_fix = 0

    def __call__(self, op: str, call: Dict) -> None:
        name = self.by_op.get(op)
        if name is not None:
            m = self.kernels[name]
            moved, ops = m.work(call, self.itemsize)
            self.bound_s[name] += max(moved / HBM_BYTES_PER_S, ops / m.PEAK_OPS_PER_S)
            self.calls[name] += 1
        if op == "sparse_conv":
            f, w, kmap, valid = call["feats"], call["weights"], call["kmap"], call["out_valid"]
            b, k, v_out = kmap.shape
            dense = 2 * b * v_out * w.shape[1] * w.shape[2] * k
            live = (kmap >= 0) if valid is None else (kmap >= 0) & valid[:, None, :]
            self.flops_fix += 2 * int(live.sum()) * w.shape[1] * w.shape[2] - dense
        elif op == "sparse_conv_transpose":
            f, w, parent = call["feats"], call["weights"], call["parent"]
            b, v_c, c_in = f.shape
            dense = 2 * b * v_c * c_in * 8 * w.shape[2]
            self.flops_fix += 2 * int((parent >= 0).sum()) * c_in * w.shape[2] - dense
        elif op == "dense_rows":
            x, w, valid = call["x"], call["w"], call["valid"]
            b, v, c_in = x.shape
            n = b * v if valid is None else int(valid.sum())
            self.flops_fix += 2 * (n - b * v) * c_in * w.shape[1]


def count(fn, itemsize: int = 2):
    """(fn's result, Work, operations) of fn() under the flop counter and
    the recorder."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.ops.record import recording

    w = Work(itemsize)
    with FlopCounterMode(display=False) as fc, recording(w):
        out = fn()
    return out, w, fc.get_total_flops() + w.flops_fix
