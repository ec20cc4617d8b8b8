"""Median latency (ms) of the frames due in the window, each from its due
time to its outputs' completion on the device (host clock)."""

import numpy as np


def read(run):
    f = run.record.get("frames")
    if f is None or not len(f):
        return None
    return float(np.percentile((f[:, 4] - f[:, 1]) * 1e3, 50))
