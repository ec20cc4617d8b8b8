"""Host ms per frame inside ``VisualHull.process_frame_fast``, from the
call until it returns (the harness's span around each call of the
untraced window; the step returns once it has read the cleanup's
overflow bits)."""

import numpy as np


def read(run):
    f = run.record.get("frames")
    if f is None or not len(f):
        return None
    return float(np.mean(f[:, 3] - f[:, 2]) * 1e3)
