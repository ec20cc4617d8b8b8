"""Host-side foreground window tracking for the ROI ingest.

Counterpart of ``vbr_tpu/utils/roi.py``, with the same decisions: per
camera, a fixed-size window that holds every foreground region that could
survive the contour-hierarchy cleanup, found with the classifier the masks
use (the frozen MOG prefix: background iff some valid mixture is within its
threshold) on a strided grid.  A component of the strided detections below
``0.8·figure_threshold / stride²`` cells cannot reach the cleanup's keep
threshold, so only the union box of the larger ones constrains the window;
when that box does not fit, the frame needs the full-frame upload.  The
ROI path's loss is measured (``VisualHull.validate_reduced_ingest``), not
assumed.

Two replacements keep it free of OpenCV, each giving the same numbers:
8-connected labelling is ``scipy.ndimage.label`` (areas by ``np.bincount``,
boxes by ``scipy.ndimage.find_objects``) in place of
``cv2.connectedComponentsWithStats``, and HSV is the port's
``ops.color.bgr_to_hsv_u8`` on CPU tensors in place of ``cv2.cvtColor``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import ndimage

from vbr_tpu_torch.ops.color import bgr_to_hsv_u8

_EIGHT = np.ones((3, 3), bool)  # 8-connectivity


def _keeper_bbox(det_u8: np.ndarray, min_cells: int):
    """Union box (y0, y1, x0, x1) of the 8-connected components with at
    least ``min_cells`` cells, or None if there is none."""
    labels, n = ndimage.label(det_u8, structure=_EIGHT)
    if n == 0:
        return None
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    boxes = ndimage.find_objects(labels)
    big = [boxes[k - 1] for k in range(1, n + 1) if areas[k] >= min_cells]
    if not big:
        return None
    return (min(b[0].start for b in big), max(b[0].stop for b in big),
            min(b[1].start for b in big), max(b[1].stop for b in big))


class MotionROITracker:
    """Per-camera fixed-size foreground window from the frozen MOG prefix.

    Parameters
    ----------
    mean, thr, bcount : the frozen state's host arrays — mean (C, H, W,
        Ke, 3), thr (C, H, W, Ke), bcount (C, H, W).
    roi_hw : the window size (rows, cols); even (2×2 chroma).
    use_hsv : classify in HSV (the production configuration).
    figure_threshold : the smallest keep threshold of the cleanup across
        cameras, in full-resolution pixels.
    margin : pixels added around the detection box before clamping.
    stride : detection grid stride (host cost ∝ 1/stride²).
    """

    def __init__(self, mean: np.ndarray, thr: np.ndarray,
                 bcount: np.ndarray, roi_hw: Tuple[int, int],
                 use_hsv: bool = True, figure_threshold: float = 5000.0,
                 margin: int = 24, stride: int = 6):
        self.C, self.H, self.W = bcount.shape
        self.rh, self.rw = roi_hw
        if self.rh % 2 or self.rw % 2:
            raise ValueError("roi_hw must be even (YUV 4:2:0 chroma)")
        if self.rh > self.H or self.rw > self.W:
            raise ValueError(f"roi_hw {roi_hw} exceeds image "
                             f"({self.H}, {self.W})")
        s = int(stride)
        self.stride = s
        self.margin = int(margin)
        self.use_hsv = bool(use_hsv)
        self.mean = np.ascontiguousarray(
            np.asarray(mean)[:, ::s, ::s], np.float32)
        self.thr = np.ascontiguousarray(
            np.asarray(thr)[:, ::s, ::s], np.float32)
        self.bcount = np.ascontiguousarray(
            np.asarray(bcount)[:, ::s, ::s], np.int32)
        self.Ke = self.thr.shape[-1]
        # a strided cell stands for stride² pixels; only components that
        # could reach the keep threshold constrain the window
        self.min_cells = max(1, int(0.8 * figure_threshold / (s * s)))
        self.offsets = np.stack([
            np.full(self.C, (self.H - self.rh) // 2 & ~1, np.int32),
            np.full(self.C, (self.W - self.rw) // 2 & ~1, np.int32),
        ], axis=1)
        self._first = True

    def _foreground(self, frames: np.ndarray) -> np.ndarray:
        """(C, Hs, Ws) bool — the masks' classifier on the strided grid,
        accumulated one mixture at a time (no (..., Ke)-wide
        temporaries)."""
        s = self.stride
        x = np.ascontiguousarray(frames[:, ::s, ::s])
        if self.use_hsv:
            x = bgr_to_hsv_u8(torch.from_numpy(x)).numpy()
        x = x.astype(np.float32)
        bg = np.zeros(x.shape[:3], bool)
        for k in range(self.Ke):
            d = x - self.mean[:, :, :, k]
            d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
            bg |= (k < self.bcount) & (d2 < self.thr[:, :, :, k])
        return ~bg

    def update(self, frames: np.ndarray):
        """(C, H, W, 3) u8 → (offsets (C, 2) i32 [y0, x0], full_needed).

        Offsets are even and clamped into the frame.  ``full_needed`` is
        True on the first frame and whenever the detections outside some
        window could hold a component the cleanup would keep.  A camera
        with no such component keeps its last window.
        """
        det = self._foreground(frames)
        full = self._first
        self._first = False
        s = self.stride
        for c in range(self.C):
            bb = _keeper_bbox(det[c].astype(np.uint8), self.min_cells)
            if bb is None:
                continue
            y0 = bb[0] * s - self.margin
            y1 = bb[1] * s + self.margin
            x0 = bb[2] * s - self.margin
            x1 = bb[3] * s + self.margin
            if (y1 - y0) > self.rh or (x1 - x0) > self.rw:
                full = True  # the keepers cannot fit the window
            # centre the window on the keepers either way: the next frames
            # gain even after a one-frame full fallback
            cy = max(0, min((y0 + y1 - self.rh) // 2, self.H - self.rh))
            cx = max(0, min((x0 + x1 - self.rw) // 2, self.W - self.rw))
            self.offsets[c] = (cy & ~1, cx & ~1)
        return self.offsets.copy(), bool(full)

    def crop(self, frames: np.ndarray) -> np.ndarray:
        """(C, H, W, 3) u8 → (C, rh, rw, 3) u8 at the current offsets."""
        out = np.empty((self.C, self.rh, self.rw, frames.shape[-1]),
                       frames.dtype)
        for c in range(self.C):
            y0, x0 = self.offsets[c]
            out[c] = frames[c, y0:y0 + self.rh, x0:x0 + self.rw]
        return out
