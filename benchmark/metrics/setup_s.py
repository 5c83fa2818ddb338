"""Seconds from the process's start to the window's start: building and
loading the model, drawing the weights and the traffic, staging, the
kernels' build where it is not cached, and the first pass (captures)."""

NAME, UNIT, KIND, KINDS = "setup_s", "s", "end_to_end", ("scene_scan", "train_step")


def read(record):
    return record["setup_s"]
