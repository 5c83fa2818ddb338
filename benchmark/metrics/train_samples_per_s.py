"""Views trained a second: the window's steps times the views a step, over
the window's seconds (the last step, which ends after the deadline,
included)."""

NAME, UNIT, KIND, KINDS = "train_samples_per_s", "samples/s", "end_to_end", ("train_step",)


def read(record):
    return record["steps"] * record["batch"] / record["window_s"]
