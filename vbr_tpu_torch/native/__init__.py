"""ctypes bindings of the port's native host tails (``vbr_host.cpp``).

Counterpart of the OpenCV-free part of ``vbr_tpu/native``:

  * :func:`yuv420_pack` — the host pack of the reduced-byte ingest,
    byte-identical to ``ops.color._bgr_to_yuv420_numpy``;
  * :func:`mc_emit` — the surface wire's triangle emission, bit-identical
    to ``ops.marching_cubes._triangles_from_wire_numpy``.

The library is built by ``g++`` at first use (``native/build.py``).  A
library that does not build or load raises: no caller falls back to numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from vbr_tpu_torch.native import build as _build

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
