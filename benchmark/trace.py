"""The traced run's view of the device: ``torch.profiler`` over a window,
recording the device's activity only (kernels, copies, fills), its events
moved onto the harness's ``time.perf_counter`` clock, and interval
arithmetic over them.  The host's operations are not recorded: recording
each of them would slow the host-bound step that the window measures."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


class Trace:
    """``device`` (name, start, end) of every kernel, copy and fill that
    ran on the device in one traced window, in seconds of
    ``time.perf_counter``."""

    def __init__(self, device):
        self.device = device

    def device_intervals(self) -> np.ndarray:
        return np.array([(s, e) for _, s, e in self.device],
                        np.float64).reshape(-1, 2)

    def kernel_times(self, pattern) -> list:
        """Durations (s) of the device operations whose name holds
        ``pattern``."""
        return [e - s for n, s, e in self.device if pattern in n]


@contextlib.contextmanager
def traced(cuda: bool):
    """Profile the body's device activity; yields a holder whose ``trace``
    is set to a :class:`Trace` once the body has run, and ``t0``, ``t1`` to
    the traced window's ends (s, ``time.perf_counter``).  Without a CUDA
    device the trace is empty.

    The clocks are tied by an anchor: with the device idle, one fill is
    launched at a known host time, and it is the trace's first device
    operation (it starts a few microseconds after its launch)."""
    holder = type("Holder", (), {"trace": None, "t0": None, "t1": None})()
    if not cuda:
        holder.t0 = time.perf_counter()
        yield holder
        holder.t1 = time.perf_counter()
        holder.trace = Trace([])
        return
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        anchor = time.perf_counter_ns()
        marker.fill_(0.0)
        torch.cuda.synchronize()
        holder.t0 = time.perf_counter()
        yield holder
        holder.t1 = time.perf_counter()
    holder.trace = _parse(prof, anchor)


def _parse(prof, anchor_ns) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((ev for ev in prof.profiler.kineto_results.events()
                     if ev.device_type() == cuda),
                    key=lambda ev: ev.start_ns())
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    offset = events[0].start_ns() - anchor_ns  # the anchor's fill
    device = []
    for ev in events[1:]:
        s = (ev.start_ns() - offset) * 1e-9
        device.append((ev.name(), s, s + ev.duration_ns() * 1e-9))
    return Trace(device)


def union(intervals) -> np.ndarray:
    """Sorted, disjoint (k, 2) union of (n, 2) intervals."""
    iv = np.asarray(intervals, np.float64).reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def intersect(a, b) -> np.ndarray:
    """The intersection of two interval unions, as a (k, 2) union."""
    a, b = union(a), union(b)
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if hi > lo:
            out.append((lo, hi))
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return np.array(out, np.float64).reshape(-1, 2)


def length(intervals) -> float:
    u = union(intervals)
    return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0


def covered(a, b) -> float:
    """Length of the intersection of two interval unions."""
    return length(intersect(a, b))


def breakdown(trace: Trace, within, spans, top=10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device inside the intervals ``within``, each named by the
    last of the harness's host spans ``spans`` [(name, start, end)] that
    holds the gap's middle."""
    by_name = {}
    for n, s, e in trace.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(trace.device_intervals())
    inside = union(within)
    if len(busy):
        edges = [min(busy[0, 0], inside[0, 0]), *busy.ravel(),
                 max(busy[-1, 1], inside[-1, 1])]
        idle = np.array(edges).reshape(-1, 2)
    else:
        idle = inside
    gaps = intersect(idle, inside)
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:top]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = "host: outside the harness's spans"
        for n, hs, he in spans:
            if hs <= mid <= he:
                label = n
        named.append([label, float(e - s)])
    return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops],
            "idle_gaps": named}
