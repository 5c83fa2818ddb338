"""Scenes served a second: the window's views over the views a scene, over
the window's seconds (the last scene, which ends after the deadline,
included)."""

NAME, UNIT, KIND, KINDS = "scenes_per_s", "scenes/s", "end_to_end", ("scene_scan",)


def read(record):
    return record["views_done"] / record["views_per_scene"] / record["window_s"]
