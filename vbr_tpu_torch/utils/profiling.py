"""Observability: per-stage timing, device tracing and numeric checking.

Counterpart of ``vbr_tpu/utils/profiling.py``:

  * :class:`StageTimer` — named stages timed by CUDA events on the current
    stream for a CUDA device (each stage also an NVTX range), by the host
    clock otherwise;
  * :func:`device_sync` — wait for the device work behind a tensor;
  * :func:`trace` — a ``torch.profiler`` trace (CPU and, where there is a
    card, CUDA activity) inside one NVTX range, written as a Chrome trace;
  * :func:`checked` — raises ``FloatingPointError`` when a function returns
    a non-finite float, the port's counterpart of checkify's
    ``float_checks``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


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
    """Accumulating named-stage timer.

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
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.nvtx.range_push(name)
                start.record()
                try:
                    yield
                finally:
                    end.record()
                    torch.cuda.nvtx.range_pop()
                    self._events[name].append((start, end))
                    self.counts[name] += 1
            return
        t0 = time.perf_counter()
        try:
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
    present), inside an NVTX range ``name``; the Chrome trace goes to
    ``log_dir/<name>.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sum the kernels."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.nvtx.range_pop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


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
