"""Observability: the recorder of host spans and counters, per-stage
timing, device tracing and numeric checking.

Counterpart of ``vbr_tpu/utils/profiling.py``, with the recorder beside it:

  * :class:`span` and :func:`count` — the recorder.  A span is a named
    interval of the host's ``time.perf_counter`` (the clock the benchmark
    ties its device trace to) with the index of the enclosing span on the
    same thread (its parent) and a request number, which a root span takes
    and its children inherit; spans go into a preallocated ring of
    ``RING_SIZE`` entries, the oldest overwritten first (``dropped``).
    Counters are named totals.  :func:`spans`, :func:`counted` and
    :func:`counters` read them back.  A span makes no CUDA call (no event,
    no synchronise, no profiler range): it times the host's enqueue of the
    work inside it and adds nothing to a device trace.  The module flag
    ``enabled`` (default True) turns recording off;
  * :class:`StageTimer` — named stages timed by CUDA events on the current
    stream for a CUDA device, by the host clock otherwise; each stage is
    also a recorder span;
  * :func:`device_sync` — wait for the device work behind a tensor;
  * :func:`trace` — a ``torch.profiler`` trace (CPU and, where there is a
    card, CUDA activity) written as a Chrome trace, with the recorder's
    spans of its window on a track of their own;
  * :func:`checked` — raises ``FloatingPointError`` when a function returns
    a non-finite float, the port's counterpart of checkify's
    ``float_checks``.

The program's spans and counters (``models/visual_hull.py``; the mask
stage's three in ``pipelines/background.py``):

    step           one ``VisualHull.process_frame_fast`` call (root)
    offline        one ``VisualHull.process_frames_offline`` call (root)
    upload         ``VisualHull._frames``: pinning and the queued copy
    masks          ``MaskStage.head``: (YUV unpack,) HSV, frozen MOG
                   apply, pre-morphology
    cleanup        ``MaskStage.cleanup``: ``ccl.clean_masks_batched``
                   (kernel K2, run tables; on a card the copy in, the
                   graph's replay and the two clones out)
    finalize       ``MaskStage.finalize``: post-morphology
                   (the three opened by ``MaskStage`` wherever it runs:
                   under ``step``, ``chunk`` and ``redo``, in a public
                   ``VisualHull.masks`` call, ``validate_reduced_ingest``
                   and the sharded step)
    carve          block activity and kernel K1 or K4, or the table carve
    overflow_wait  the live step's wait for the cleanup's overflow bits
    redo           a frame redone exactly (host cleanup or table path)
    chunk          one chunk of the offline path, its downloads included
    pad            under the last ``chunk``: its padding on the device
    download       a chunk's occupancy and overflow bits into their rows
                   of the call's result on the host
    colors         under ``chunk``: a chunk's colour gather on the device
                   and its download; under ``offline``: the split into
                   the per-frame list and the redone frames' colours

    redos          frames redone exactly (one per ``redo`` span)
    host_cleanups  cameras cleaned by ``ccl.clean_mask_host``
    color_voxels   voxels whose colours a chunk's gather kept (its frames
                   past the video's end and its redone frames left out)
    padded_frames  frames that padded an offline call's last chunk
    cleanup_graph_captures  graphs of ``ccl.clean_masks_batched`` captured
                   (one per input shape, thresholds and caps)
    cleanup_graph_replays   calls of it served by replaying a graph
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Tuple

import torch

RING_SIZE = 65536  # spans (and counter increments) the recorder keeps
enabled = True  # False: spans and counts record nothing


class Span(NamedTuple):
    """One recorded span; times in s of ``time.perf_counter``."""

    index: int  # its number among every span the recorder opened
    name: str
    start: float
    end: float
    parent: int  # index of the enclosing span on the same thread, or -1
    request: int  # taken by a root span, inherited by its children
    thread: int  # ``threading.get_ident()`` of the thread that opened it


class Recorder:
    """A fixed ring of ``size`` spans, each written when it closes, and a
    set of named counters (each increment also kept, with its time, in a
    ring of ``size``).  :class:`span` opens and closes the spans."""

    def __init__(self, size: int = RING_SIZE):
        self.size = int(size)
        # (index, name, start, end, parent, request, thread) per slot
        self._ring = [None] * self.size
        self._next = itertools.count()  # next() is atomic under the GIL
        self._requests = itertools.count()
        self._local = threading.local()  # .stack: the thread's open spans
        self.dropped = 0  # spans overwritten by newer ones
        self._dropped_start = -math.inf  # the latest start among them
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._count_log = deque(maxlen=self.size)
        self._dropped_count_t = None  # time of the latest increment dropped

    def _keep(self, entry) -> None:
        """Put a closed span into its slot, unless a newer span holds it."""
        s = entry[0] % self.size
        old = self._ring[s]
        if old is not None and old[0] > entry[0]:
            old, entry = entry, old
        self._ring[s] = entry
        if old is not None:
            self.dropped += 1
            self._dropped_start = max(self._dropped_start, old[2])

    def spans(self, t0: float = -math.inf,
              t1: float = math.inf) -> Tuple[List[Span], bool]:
        """The kept spans, closed, that start in [t0, t1], by index, and
        whether the ring has overwritten spans that started at or after
        ``t0``."""
        out = sorted(Span(*e) for e in list(self._ring)
                     if e is not None and t0 <= e[2] <= t1)
        return out, self.dropped > 0 and self._dropped_start >= t0

    def count(self, name: str, n: int = 1) -> None:
        t = time.perf_counter()
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            if len(self._count_log) == self.size:
                self._dropped_count_t = self._count_log[0][0]
            self._count_log.append((t, name, n))

    def counters(self) -> Dict[str, int]:
        """Every counter's total."""
        with self._lock:
            return dict(self._counts)

    def counted(self, t0: float = -math.inf,
                t1: float = math.inf) -> Tuple[Dict[str, int], bool]:
        """Each counter's increments made in [t0, t1], and whether the ring
        of increments has overwritten any made at or after ``t0``."""
        with self._lock:
            log = list(self._count_log)
            overwritten = (self._dropped_count_t is not None
                           and self._dropped_count_t >= t0)
        out: Dict[str, int] = {}
        for t, name, n in log:
            if t0 <= t <= t1:
                out[name] = out.get(name, 0) + n
        return out, overwritten


RECORDER = Recorder()


class span:
    """``with span("name"):`` records the block as a span of ``recorder``
    (the module's :data:`RECORDER` by default) while :data:`enabled`: its
    index, parent and request are fixed when it opens, and it enters the
    ring when it closes."""

    __slots__ = ("name", "recorder", "_open")

    def __init__(self, name: str, recorder: Recorder = None):
        self.name = name
        self.recorder = RECORDER if recorder is None else recorder

    def __enter__(self):
        if not enabled:
            self._open = None
            return self
        rec = self.recorder
        i = next(rec._next)
        try:
            stack = rec._local.stack
        except AttributeError:
            stack = rec._local.stack = []
            rec._local.thread = threading.get_ident()
        if stack:
            parent, request = stack[-1][0], stack[-1][2]
        else:
            parent, request = -1, next(rec._requests)
        self._open = (i, parent, request, time.perf_counter())
        stack.append(self._open)
        return self

    def __exit__(self, *exc):
        o = self._open
        if o is not None:
            t = time.perf_counter()
            rec = self.recorder
            rec._local.stack.pop()
            rec._keep((o[0], self.name, o[3], t, o[1], o[2],
                       rec._local.thread))
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while :data:`enabled`."""
    if enabled:
        RECORDER.count(name, n)


def spans(t0: float = -math.inf, t1: float = math.inf):
    """:meth:`Recorder.spans` of the module's recorder."""
    return RECORDER.spans(t0, t1)


def counted(t0: float = -math.inf, t1: float = math.inf):
    """:meth:`Recorder.counted` of the module's recorder."""
    return RECORDER.counted(t0, t1)


def counters() -> Dict[str, int]:
    """:meth:`Recorder.counters` of the module's recorder."""
    return RECORDER.counters()


def _device_of(x):
    """``x``'s device: a tensor's own, else ``x`` read as a device."""
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device(x)


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of ``x`` and of the tuples, lists and dict values it
    nests."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    return []


def device_sync(x) -> None:
    """Wait until the device work behind ``x`` (a tensor, or tuples, lists
    and dicts of them) has finished; a CPU tensor has nothing to wait
    for."""
    for dev in {t.device for t in _tensors(x)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating named-stage timer; each stage is also a recorder
    :class:`span` named after it.

    >>> timer = StageTimer()
    >>> with timer("masks", device=frames):
    ...     masks = model.masks(frames)
    >>> timer.report()

    With a CUDA ``device`` (a device or a tensor on it) a stage is the span
    between two CUDA events on the current stream, read when the totals
    are (so timing does not make the host wait); otherwise it is the host
    clock around the block, which for work queued on a card measures only
    the queueing."""

    def __init__(self):
        self._host: Dict[str, float] = defaultdict(float)
        self._events: Dict[str, list] = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, device=None):
        dev = _device_of(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev), span(name):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    yield
                finally:
                    end.record()
                    self._events[name].append((start, end))
                    self.counts[name] += 1
            return
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._host[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage (waits for the stages' end events)."""
        out = defaultdict(float, self._host)
        for name, pairs in self._events.items():
            for start, end in pairs:
                end.synchronize()
                out[name] += start.elapsed_time(end) / 1e3
        return out

    def mean_ms(self, name: str) -> float:
        return 1e3 * self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = [
            f"{name}: {self.mean_ms(name):8.2f} ms/call × {self.counts[name]}"
            for name in sorted(self.counts)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "artifacts/trace", name: str = "trace"):
    """``torch.profiler`` over the block (CUDA activity too where a card is
    present); the Chrome trace goes to ``log_dir/<name>.json`` (open it in
    Perfetto or chrome://tracing) with the recorder's spans that start in
    the block on a track of their own.  Yields the profiler, whose
    ``key_averages()`` sum the kernels.

    The clocks are tied by an anchor: a one-element fill launched at a
    known ``time.perf_counter`` is the second operation the profiler
    records (after another fill, which takes the first operation's delay),
    and each span is placed at its offset from the fill's host start."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    marker = torch.zeros(1, device="cuda" if cuda else "cpu")
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        marker.fill_(0.0)  # the profiler's first operation records late
        anchor = time.perf_counter()
        marker.fill_(1.0)
        t0 = time.perf_counter()
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, anchor, spans(t0, t1)[0])


SPAN_TID = 900_000_000  # the spans' track ids in a Chrome trace, upward


def _add_spans(path: str, anchor: float, recorded: List[Span]) -> None:
    """Write ``recorded`` into the Chrome trace at ``path``, each on the
    trace's clock: the anchor fill's host start (the second
    ``aten::fill_`` of the trace) plus the span's offset from ``anchor``
    (s, ``time.perf_counter``).  One track per thread."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    fills = sorted(e["ts"] for e in events
                   if e.get("name") == "aten::fill_" and e.get("ph") == "X")
    if len(fills) < 2:
        raise RuntimeError(f"no anchor fill in the trace {path}")
    base = float(fills[1])
    pid = os.getpid()
    tracks = {}
    for s in recorded:
        if s.thread not in tracks:
            tracks[s.thread] = tid = SPAN_TID + len(tracks)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {
                               "name": f"spans, thread {s.thread}"}})
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid,
            "tid": tracks[s.thread], "ts": base + (s.start - anchor) * 1e6,
            "dur": (s.end - s.start) * 1e6,
            "args": {"index": s.index, "parent": s.parent,
                     "request": s.request}})
    with open(path, "w") as f:
        json.dump(doc, f)


def checked(fn):
    """``fn`` with its float outputs checked: a NaN or an infinity in any
    floating-point tensor it returns (also inside tuples, lists and dicts)
    raises ``FloatingPointError``.

    JAX's checkify also traps NaNs of intermediates and integer division by
    zero inside jitted code; here only the outputs are read, and integer
    division by zero is not caught on the card (CUDA gives an undefined
    value without a trap)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, t in enumerate(_tensors(out)):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'function')} returned a "
                    f"non-finite value in float output {i}")
        return out

    return wrapper
