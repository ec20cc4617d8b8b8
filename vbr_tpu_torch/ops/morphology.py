"""Rectangular-kernel morphology with OpenCV's border and anchor rules.

Counterpart of ``vbr_tpu/ops/morphology.py``.  Pixels outside the image
never influence the result (erode pads with 255, dilate with 0), and an
even kernel is anchored at k//2: the window of pixel y spans rows
[y − k//2, y − k//2 + k), i.e. pad k//2 low and k − 1 − k//2 high.
Works on the last two dimensions of any integer tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_reduce(img, ksize, fill, reduce):
    kh, kw = ksize
    ah, aw = kh // 2, kw // 2
    f = F.pad(img.to(torch.int32), (aw, kw - 1 - aw, ah, kh - 1 - ah),
              value=fill)
    H, W = img.shape[-2:]
    out = None
    for dy in range(kh):
        for dx in range(kw):
            win = f[..., dy:dy + H, dx:dx + W]
            out = win if out is None else reduce(out, win)
    return out.to(img.dtype)


def erode(img: torch.Tensor, ksize=(3, 3)) -> torch.Tensor:
    return _window_reduce(img, ksize, 255, torch.minimum)


def dilate(img: torch.Tensor, ksize=(3, 3)) -> torch.Tensor:
    return _window_reduce(img, ksize, 0, torch.maximum)


def opening(img: torch.Tensor, ksize=(3, 3)) -> torch.Tensor:
    """Erode then dilate (cv2.MORPH_OPEN)."""
    return dilate(erode(img, ksize), ksize)


def closing(img: torch.Tensor, ksize=(3, 3)) -> torch.Tensor:
    """Dilate then erode (cv2.MORPH_CLOSE)."""
    return erode(dilate(img, ksize), ksize)
