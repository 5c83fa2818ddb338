"""K3's share of its roofline in the traced stretch: the least time its
calls need (kernels/k3.py, from the reference's calls at the served views)
over the device time of its launches."""

from benchmark.harness.core import BENCH, load_module
from benchmark.harness.trace import kernel_seconds

NAME, UNIT, KIND, KINDS = "k3_roofline.serve", "%", "per_layer", ("scene_scan",)
KERNEL = load_module(BENCH / "kernels" / "k3.py", "benchmark_kernel_k3")


def read(record):
    tr, vw = record.get("trace"), record.get("view_work")
    if not tr or not vw or not vw["calls"].get("k3"):
        return None
    spent = kernel_seconds(tr, KERNEL.PATTERNS)
    if spent <= 0:
        return None
    return 100.0 * vw["bound_s"]["k3"] * record["trace_views"] / spent
