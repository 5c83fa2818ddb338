"""K1's share of its roofline in the traced training steps: the least time
its calls of a step need (kernels/k1.py, from the reference's calls on the
step's first batch, remat's recompute included, as the program launches
it) over the device time of its launches."""

from benchmark.harness.core import BENCH, load_module
from benchmark.harness.trace import kernel_seconds

NAME, UNIT, KIND, KINDS = "k1_roofline.train", "%", "per_layer", ("train_step",)
KERNEL = load_module(BENCH / "kernels" / "k1.py", "benchmark_kernel_k1")


def read(record):
    tr, sw = record.get("trace"), record.get("step_work")
    if not tr or not sw or not sw["calls"].get("k1"):
        return None
    spent = kernel_seconds(tr, KERNEL.PATTERNS)
    if spent <= 0:
        return None
    return 100.0 * sw["bound_s"]["k1"] * record["trace_steps"] / spent
