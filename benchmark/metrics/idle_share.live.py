"""Idle share of the device (%) inside the traced window's frames, each
from its due time to its completion: 100 × (1 − device activity ÷ their
union).  Between frames the device waits for the next due time, which
says nothing of the step; inside them, idle time is the host's."""

from benchmark import trace as tr


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    f = run.trace_record.get("frames")
    if f is None or not len(f):
        return None
    within = f[:, [1, 4]]
    busy = tr.covered(run.trace.device_intervals(), within)
    return 100.0 * (1.0 - busy / tr.length(within))
