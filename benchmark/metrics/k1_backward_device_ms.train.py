"""Device ms a step of the work under autograd's `_SparseConvBackward`
nodes (K1's backward, today the plain VJP), in the traced steps."""

NAME, UNIT, KIND, KINDS = "k1_backward_device_ms.train", "ms", "per_layer", ("train_step",)


def read(record):
    tr = record.get("trace")
    if not tr or not tr["nodes"].get("_SparseConvBackward"):
        return None
    return 1e3 * tr["nodes"]["_SparseConvBackward"] / record["trace_steps"]
