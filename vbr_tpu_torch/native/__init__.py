"""The port's native host runtime: ctypes bindings of ``vbr_host.cpp``
and the host video threads.

Counterpart of ``vbr_tpu/native``:

  * :func:`yuv420_pack` — the host pack of the reduced-byte ingest,
    byte-identical to ``ops.color._bgr_to_yuv420_numpy``;
  * :func:`mc_emit` — the surface wire's triangle emission, bit-identical
    to ``ops.marching_cubes._triangles_from_wire_numpy``;
  * :class:`PrefetchingSource` — synchronized multi-camera decode, one
    thread per camera filling a bounded queue (PIL's JPEG decoder releases
    the GIL), so decoding overlaps the device's work;
  * :class:`VideoSink` — an MJPEG AVI writer (``utils.video.AviWriter``).

``vbr_tpu``'s source and sink are C++ over OpenCV; these are Python over
``utils/video.py``, and the sink writes MJPEG in an AVI file where
``vbr_tpu``'s writes mp4v.  ``vbr_tpu``'s ``MOGOracle`` is OpenCV's own
bgsegm model and has no counterpart.

The library is built by ``g++`` at first use (``native/build.py``).  A
library that does not build or load raises: no caller falls back to numpy.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np

from vbr_tpu_torch.native import build as _build
from vbr_tpu_torch.utils import video as vio

_LIBS = {}  # library path → loaded, bound library


def _lib():
    path = _build.build()
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        lib.vbr_yuv420_pack.restype = None
        lib.vbr_yuv420_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.vbr_mc_emit.restype = ctypes.c_int
        lib.vbr_mc_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIBS[path] = lib
    return lib


def mc_emit(idx, cfg, n, table, tvalid, ny1, nz1, origin, spacing):
    """Triangles of the first ``n`` wire cells → (M, 9) f32: ``idx`` cell
    indices, ``cfg`` their configurations, ``table`` (256, T, 9) f32
    vertices relative to the cell base, ``tvalid`` (256, T) flags,
    ``ny1``/``nz1`` the cell grid's last two dims, ``origin`` and
    ``spacing`` (3,) world placement."""
    n = min(int(n), len(idx), len(cfg))  # a truncated result: no over-read
    idx = np.ascontiguousarray(idx[:n], np.int32)
    cfg = np.ascontiguousarray(cfg[:n], np.uint8)
    table = np.ascontiguousarray(table, np.float32)
    tvalid = np.ascontiguousarray(tvalid, np.uint8)
    if table.ndim != 3 or table.shape[0] != 256 or table.shape[2] != 9:
        raise ValueError(f"table must be (256, T, 9), got {table.shape}")
    T = table.shape[1]
    if tvalid.shape != (256, T):
        raise ValueError(f"tvalid must be (256, {T}), got {tvalid.shape}")
    origin = np.ascontiguousarray(origin, np.float32).reshape(3)
    spacing = np.ascontiguousarray(spacing, np.float32).reshape(3)
    out = np.empty((n * T, 9), np.float32)
    m = _lib().vbr_mc_emit(
        idx.ctypes.data_as(ctypes.c_void_p),
        cfg.ctypes.data_as(ctypes.c_void_p), n,
        table.ctypes.data_as(ctypes.c_void_p),
        tvalid.ctypes.data_as(ctypes.c_void_p), T,
        int(ny1), int(nz1),
        origin.ctypes.data_as(ctypes.c_void_p),
        spacing.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:m]


def yuv420_pack(frames: np.ndarray) -> np.ndarray:
    """(C, H, W, 3) u8 BGR → (C, H·3/2, W) u8 YUV 4:2:0, H and W even."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (C, H, W, 3), got {frames.shape}")
    C, H, W = frames.shape[:3]
    if H % 2 or W % 2:
        raise ValueError(f"H and W must be even (2x2 chroma), got {H}x{W}")
    out = np.empty((C, H * 3 // 2, W), np.uint8)
    _lib().vbr_yuv420_pack(
        frames.ctypes.data_as(ctypes.c_void_p), C, H, W,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


_END = object()  # a camera's stream ended


class PrefetchingSource:
    """Synchronized multi-camera video source: one decoding thread per
    camera, each ahead by up to ``queue_capacity`` frames.

    ``next_frames()`` returns (C, H, W, 3) u8 BGR, or None once any
    camera's stream has ended; an error in a decoding thread is raised
    again there.  Every file is opened at construction (a missing one
    raises ``FileNotFoundError``, an unsupported codec ``ValueError``)."""

    def __init__(self, paths: Sequence[str], queue_capacity: int = 8):
        if not paths:
            raise ValueError("PrefetchingSource needs at least one path")
        self._caps: List = []
        try:
            for p in paths:
                self._caps.append(vio._capture(p))
        except BaseException:
            for cap in self._caps:
                cap.release()
            raise
        self.num_cameras = len(self._caps)
        self.width, self.height = self._caps[0].width, self._caps[0].height
        self._stop = threading.Event()
        self._queues = [queue.Queue(max(1, int(queue_capacity)))
                        for _ in self._caps]
        self._ended = False
        self._threads = [
            threading.Thread(target=self._decode, args=(cap, q), daemon=True,
                             name=f"vbr-decode-{i}")
            for i, (cap, q) in enumerate(zip(self._caps, self._queues))]
        for t in self._threads:
            t.start()

    def _put(self, q, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _decode(self, cap, q):
        try:
            while not self._stop.is_set():
                ok, frame = cap.read()
                if not self._put(q, frame if ok else _END) or not ok:
                    return
        except BaseException as e:  # handed to the consumer
            self._put(q, e)
        finally:
            cap.release()

    def next_frames(self) -> Optional[np.ndarray]:
        """(C, H, W, 3) u8 BGR batch, or None at the end of any stream."""
        if self._ended or self._stop.is_set():
            return None
        frames = []
        for q in self._queues:
            item = q.get()
            if isinstance(item, BaseException):
                self._ended = True
                raise item
            if item is _END:
                self._ended = True
                return None
            frames.append(item)
        return np.stack(frames)

    def close(self):
        """Stop the threads and release the files."""
        self._stop.set()
        for q in getattr(self, "_queues", ()):
            while True:  # unblock a thread waiting to put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in getattr(self, "_threads", ()):
            t.join()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoSink(vio.AviWriter):
    """MJPEG AVI writer of (H, W, 3) u8 BGR frames at ``fps``: the
    annotated calibration videos and ``render --animate``'s orbit
    (``write``, ``close``, a context manager)."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        super().__init__(path, fps, width, height)
