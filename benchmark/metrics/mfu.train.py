"""The whole training step's share of the card's bf16 dense peak (989
TFLOP/s): the operations of the reference's step (forward and backward,
without remat's recompute; dense ops from the flop counter, sparse convs
over their live pairs), counted on one view and taken for each view of the
batch, times the traced steps, over the stretch's wall time."""

from benchmark.kernels.peaks import BF16_OPS_PER_S

NAME, UNIT, KIND, KINDS = "mfu.train", "%", "per_layer", ("train_step",)


def read(record):
    tr, flops = record.get("trace"), record.get("step_flops")
    if not tr or not flops:
        return None
    return 100.0 * flops * record["trace_steps"] / tr["wall_s"] / BF16_OPS_PER_S
