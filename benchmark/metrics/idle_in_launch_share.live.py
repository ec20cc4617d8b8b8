"""The share (%) of the device's idle time inside the traced window's
frames (each from its due time to its completion) that lies under the
live step's launch spans (``upload``, ``masks``, ``cleanup``,
``finalize``, ``carve`` of ``vbr_tpu_torch.utils.profiling``): the device
waiting while the host launches its work.  The spans and the device
events share ``time.perf_counter`` (the trace's anchor fill)."""

import numpy as np

from benchmark import spans
from benchmark import trace as tr


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    w = spans.window(run, traced=True)
    if w is None:
        return None
    busy = tr.union(run.trace.device_intervals())
    between = np.concatenate([[-np.inf], busy.ravel(), [np.inf]])
    idle = tr.intersect(run.trace_record["frames"][:, [1, 4]],
                        between.reshape(-1, 2))
    launch = [(s.start, s.end) for s in w[0] if s.name in spans.LAUNCH]
    total = tr.length(idle)
    under = tr.covered(idle, launch)
    return 100.0 * under / total if total > 0 and under > 0 else None
