"""Closed loop of one client over the offline path: the whole video per
call of ``VisualHull.process_frames_offline`` (as ``apps/cli.py``'s
``pipeline --offline N`` calls it), which returns occupancy and colours on
the host; calls follow each other while the window is open, and the
window ends when the last call ends."""

from __future__ import annotations

import time

import numpy as np

from benchmark import rigdata


def warm(model, inputs, traffic, sync):
    """Set-up's share: one call on the video's first chunk and on the
    chunk that starts at its first burst frame (its exact redo), if the
    video has one."""
    nf = int(traffic["frames_per_launch"])
    video = inputs.video
    bursts = [t for t in range(len(video)) if rigdata.is_burst(traffic, t)]
    starts = [0] + [min(t, len(video) - nf) for t in bursts[:1]]
    model.process_frames_offline(
        np.concatenate([video[s:s + nf] for s in starts]),
        frames_per_launch=nf)
    sync()


def due_count(traffic, seconds) -> int:
    """Frames of one call (the check draws from them)."""
    return int(traffic["video_frames"])


def window(model, inputs, traffic, seconds, keep, sync):
    """Run the window; ``keep`` holds the video frames whose outputs are
    checked, from every call.  Returns (record, kept): ``calls``, per call
    its start and end (s, ``time.perf_counter``) and its frame count, and
    ``handling_s``, the seconds spent keeping outputs between calls; and
    the kept outputs [(video frame, occ, col)] as host arrays, colours 0
    off the hull."""
    nf = int(traffic["frames_per_launch"])
    video = inputs.video
    rec, raw = [], []
    handling = 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        start = time.perf_counter()
        occ, colors = model.process_frames_offline(video,
                                                   frames_per_launch=nf)
        end = time.perf_counter()
        rec.append((start, end, len(video)))
        raw.extend((j, occ[j].copy(), colors[j]) for j in sorted(keep))
        del occ, colors
        handling += time.perf_counter() - end
    kept = []
    for j, occ_j, (idx, col) in raw:
        full = np.zeros((occ_j.shape[0], 3), np.uint8)
        full[idx] = col
        kept.append((j, occ_j, full))
    return {"calls": np.array(rec), "handling_s": handling}, kept


def spans(record) -> list:
    """The host's spans in a window's record, (name, start, end)."""
    return [("host: inside process_frames_offline", s, e)
            for s, e, _ in record["calls"]]


def intervals(record):
    """The window, from the first call's start to the last call's end."""
    c = record["calls"]
    return [(c[0, 0], c[-1, 1])]


def host_s(record) -> float:
    """Mean host seconds per call, from the call until it returns."""
    c = record["calls"]
    return float((c[:, 1] - c[:, 0]).mean())
