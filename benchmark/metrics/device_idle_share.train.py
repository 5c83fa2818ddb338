"""The share of the traced steps' wall time in which no operation ran on
the card: 1 minus the union of kernel intervals over the host clock's
length of the stretch. Nothing when the profiler lost records."""

NAME, UNIT, KIND, KINDS = "device_idle_share.train", "%", "per_layer", ("train_step",)


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
