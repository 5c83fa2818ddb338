"""The whole view step's share of the card's bf16 dense peak (989 TFLOP/s):
the operations the reference's forward needs at the served views (dense
ops from the flop counter, sparse convs over their live pairs), times the
views of the traced stretch, over the stretch's wall time."""

from benchmark.kernels.peaks import BF16_OPS_PER_S

NAME, UNIT, KIND, KINDS = "mfu.serve", "%", "per_layer", ("scene_scan",)


def read(record):
    tr, vw = record.get("trace"), record.get("view_work")
    if not tr or not vw:
        return None
    return 100.0 * vw["flops"] * record["trace_views"] / tr["wall_s"] / BF16_OPS_PER_S
