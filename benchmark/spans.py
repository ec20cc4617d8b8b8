"""The program's own spans and counters over a window of a run: the
recorder of ``vbr_tpu_torch.utils.profiling``, whose spans lie on
``time.perf_counter``, the clock of the harness's records.  A reader gets
None where the program has no such recorder, where the recorder no longer
holds the whole window, or where the window holds no span."""

from __future__ import annotations

import importlib

# the live step's launch stages, each a child of a ``step`` span
LAUNCH = ("upload", "masks", "cleanup", "finalize", "carve")


def _recorder():
    try:
        prof = importlib.import_module("vbr_tpu_torch.utils.profiling")
    except ImportError:
        return None
    if not (hasattr(prof, "spans") and hasattr(prof, "counted")):
        return None
    return prof


def units(record) -> int:
    """Frames (open loop) or calls (closed loop) of a window's record."""
    rows = record.get("frames")
    return len(rows if rows is not None else record.get("calls", ()))


def _bounds(record):
    """The window from the first call's start to the last call's end."""
    f = record.get("frames")
    if f is not None:
        return float(f[0, 2]), float(f[-1, 4])
    c = record["calls"]
    return float(c[0, 0]), float(c[-1, 1])


def window(run, traced: bool = False):
    """(spans, counter increments) of the untraced window of ``run``, or of
    its traced window; None as the module says."""
    prof = _recorder()
    record = run.trace_record if traced else run.record
    if prof is None or record is None or not units(record):
        return None
    t0, t1 = _bounds(record)
    got, overwritten = prof.spans(t0, t1)
    counts, lost = prof.counted(t0, t1)
    if overwritten or lost or not got:
        return None
    return got, counts


def seconds_under(got, names, parent) -> float:
    """Summed seconds of the spans in ``got`` named in ``names`` whose
    enclosing span is named ``parent``."""
    named = {s.index: s.name for s in got}
    return sum(s.end - s.start for s in got
               if s.name in names and named.get(s.parent) == parent)


def per_unit(run, names, parent, scale=1.0):
    """``scale`` × the seconds of the untraced window's spans ``names``
    under ``parent`` spans per frame or call; None where there are none."""
    w = window(run)
    if w is None:
        return None
    total = seconds_under(w[0], names, parent)
    return scale * total / units(run.record) if total > 0 else None
