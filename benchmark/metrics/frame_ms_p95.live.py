"""The 95th percentile of the frame latency (ms) over every frame due in
the untraced window, each from its due time to its outputs' completion
on the device (host clock): the live tail, beside ``frame_ms_p50``."""

import numpy as np


def read(run):
    f = run.record.get("frames")
    if f is None or not len(f):
        return None
    return float(np.percentile((f[:, 4] - f[:, 1]) * 1e3, 95))
