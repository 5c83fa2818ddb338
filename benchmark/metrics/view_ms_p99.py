"""The 99th percentile, over every view of the window, of the time from the
previous view's end (or its scene's start) to the view's end, from CUDA
events on the stream after each replay: the highest percentile with ten
views or more beyond it in a window (~1,100 views in 51 s)."""

import numpy as np

NAME, UNIT, KIND, KINDS = "view_ms_p99", "ms", "end_to_end", ("scene_scan",)


def read(record):
    return float(np.percentile(np.asarray(record["view_s"]) * 1e3, 99))
