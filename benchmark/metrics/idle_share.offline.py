"""Idle share of the device (%) over the traced window, from the first
call's start to the last call's end: 100 × (1 − device activity ÷
window)."""

from benchmark import trace as tr


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    c = run.trace_record.get("calls")
    if c is None or not len(c):
        return None
    within = [(c[0, 0], c[-1, 1])]
    busy = tr.covered(run.trace.device_intervals(), within)
    return 100.0 * (1.0 - busy / tr.length(within))
