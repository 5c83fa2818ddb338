"""Device ms a view of every operation that no kernels/ file claims (the
plain PyTorch ops: GroupNorm, cuDNN convolutions, cuBLAS matmuls,
elementwise), in the traced stretch."""

from benchmark.harness.work import kernel_modules
from benchmark.harness.trace import kernel_seconds

NAME, UNIT, KIND, KINDS = "plain_ops_device_ms.serve", "ms", "per_layer", ("scene_scan",)


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    claimed = sum(kernel_seconds(tr, m.PATTERNS) for m in kernel_modules().values())
    return 1e3 * (sum(tr["by_name"].values()) - claimed) / record["trace_views"]
