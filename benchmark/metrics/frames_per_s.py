"""Frames completed per second: every frame of every call over the time
from the first call's start to the last call's end, less the time the
harness spent keeping outputs for the check between calls (host
clock)."""


def read(run):
    c = run.record.get("calls")
    if c is None or not len(c):
        return None
    span = c[-1, 1] - c[0, 0] - run.record["handling_s"]
    return float(c[:, 2].sum() / span)
