"""Open loop over the live step: frame k of the video (cycled) is due at
t0 + k / ``rate_fps``; each is handed to ``VisualHull.process_frame_fast``
(canonical layout, as ``apps/cli.py``'s ``pipeline`` calls it) once it is
due and the host is free, and is done when its occupancy and colours are
complete on the device.  A frame's latency runs from its due time, so a
stall counts against every frame queued behind it."""

from __future__ import annotations

import time

import numpy as np

from benchmark import rigdata

SPIN_S = 0.0005  # the last stretch before a due time is spun, not slept


def warm(model, inputs, traffic, sync):
    """Set-up's share: the step on the first ``warmup_frames`` frames and
    on the first burst frame (its exact redo), if the video has one."""
    video = inputs.video
    warmup = [k % len(video) for k in range(int(traffic["warmup_frames"]))]
    bursts = [t for t in range(len(video)) if rigdata.is_burst(traffic, t)]
    for j in warmup + bursts[:1]:
        model.process_frame_fast(video[j])
        sync()


def due_count(traffic, seconds) -> int:
    """Frames due in a window of ``seconds``."""
    return int(np.ceil(seconds * float(traffic["rate_fps"])))


def window(model, inputs, traffic, seconds, keep, sync):
    """Run the window; ``keep`` holds the frame numbers whose outputs are
    checked.  Returns (record, kept): ``frames``, per frame its video
    frame, due, start, return and done times (s, ``time.perf_counter``),
    and the kept outputs [(video frame, occ, col)] as the step returned
    them."""
    video = inputs.video
    period = 1.0 / float(traffic["rate_fps"])
    n = due_count(traffic, seconds)
    rec = np.zeros((n, 5))
    kept = []
    t0 = time.perf_counter() + 0.05
    for k in range(n):
        due = t0 + k * period
        while True:
            left = due - time.perf_counter()
            if left <= 0:
                break
            if left > SPIN_S:
                time.sleep(left - SPIN_S)
        start = time.perf_counter()
        j = k % len(video)
        occ, col = model.process_frame_fast(video[j])
        ret = time.perf_counter()
        sync()
        done = time.perf_counter()
        rec[k] = (j, due, start, ret, done)
        if k in keep:
            kept.append((j, occ, col))
    return {"frames": rec}, kept


def spans(record) -> list:
    """The host's spans in a window's record, (name, start, end)."""
    out = []
    for _, due, start, ret, done in record["frames"]:
        out += [("host: the previous frame (queued)", due, start),
                ("host: inside process_frame_fast", start, ret),
                ("host: synchronising", ret, done)]
    return out


def intervals(record):
    """The frames' own intervals, each from its due time to done."""
    return record["frames"][:, [1, 4]]


def host_s(record) -> float:
    """Mean host seconds per call, from the call until it returns."""
    f = record["frames"]
    return float((f[:, 3] - f[:, 2]).mean())
