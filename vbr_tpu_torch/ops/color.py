"""Colour-space and intensity transforms with OpenCV's 8-bit
conventions, and the YUV 4:2:0 wire format of the reduced-byte ingest.

Counterpart of ``vbr_tpu/ops/color.py``'s ``bgr_to_hsv_u8``, bit-exact:
the same int32 fixed-point tables (hsv_shift = 12) and half-to-even
rounding (``torch.round``, like ``jnp.round`` and OpenCV's cvRound); of
its ``bgr_to_gray_u8``, ``equalize_hist_u8``, ``threshold_binary`` and
``threshold_binary_inv`` (the calibration's board segmentation), each on
the tensor's device; and
of its ``bgr_to_yuv420_host`` / ``yuv420_to_bgr_u8``: the host pack
((C, H, W, 3) u8 BGR → (C, H·3/2, W) u8: the Y plane, then H/2 rows of U
on the left and V on the right, integer BT.601 full range, each chroma
sample the rounded mean of a 2×2 block) and its unpack on the tensor's
device.  The format is lossy (chroma subsampling), so a stream that uses
it is held to the measured guard ``VisualHull.validate_reduced_ingest``.
"""

from __future__ import annotations

import numpy as np
import torch

from vbr_tpu_torch import native


def bgr_to_hsv_u8(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → (..., 3) u8 HSV: H ∈ [0, 180), S, V ∈ [0, 255]."""
    b = bgr[..., 0].to(torch.int32)
    g = bgr[..., 1].to(torch.int32)
    r = bgr[..., 2].to(torch.int32)
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn

    shift = 12
    vf = torch.where(v > 0, v, 1).to(torch.float32)
    df = torch.where(diff > 0, diff, 1).to(torch.float32)
    sdiv = torch.where(v > 0, torch.round(255.0 * 4096.0 / vf),
                       0.0).to(torch.int32)
    hdiv = torch.where(diff > 0, torch.round(30.0 * 4096.0 / df),
                       0.0).to(torch.int32)

    s = (diff * sdiv + (1 << (shift - 1))) >> shift
    h_num = torch.where(
        v == r,
        (g - b) * hdiv,
        torch.where(v == g, ((b - r) + 2 * diff) * hdiv,
                    ((r - g) + 4 * diff) * hdiv),
    )
    h = (h_num + (1 << (shift - 1))) >> shift
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def bgr_to_gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → (...) u8 gray: Rec.601 weights in f32, one
    operation at a time, rounded half to even."""
    b = bgr[..., 0].to(torch.float32)
    g = bgr[..., 1].to(torch.float32)
    r = bgr[..., 2].to(torch.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return torch.round(y).to(torch.uint8)


def equalize_hist_u8(gray: torch.Tensor) -> torch.Tensor:
    """Histogram equalization as ``cv2.equalizeHist``: lut[i] =
    round((cdf[i] − cdf_min) · 255 / (N − cdf_min)) in f32, cdf_min the
    cumulative count at the first occupied bin.  No host sync."""
    flat = gray.reshape(-1)
    hist = torch.bincount(flat.to(torch.int64), minlength=256)
    cdf = torch.cumsum(hist, 0)
    cdf_min = cdf[torch.argmax((hist > 0).to(torch.uint8))]
    denom = torch.clamp(flat.numel() - cdf_min, min=1)
    lut = torch.round((cdf - cdf_min).to(torch.float32) * 255.0
                      / denom.to(torch.float32))
    lut = lut.clamp(0, 255).to(torch.uint8)
    return lut[flat.to(torch.int64)].reshape(gray.shape)


def threshold_binary(img: torch.Tensor, thresh: float,
                     maxval: int = 255) -> torch.Tensor:
    """``cv2.threshold(img, t, maxval, THRESH_BINARY)``: maxval·(img > t)."""
    return torch.where(img > thresh, maxval, 0).to(torch.uint8)


def threshold_binary_inv(img: torch.Tensor, thresh: float,
                         maxval: int = 255) -> torch.Tensor:
    """THRESH_BINARY_INV: maxval·(img <= t)."""
    return torch.where(img > thresh, 0, maxval).to(torch.uint8)


def bgr_to_yuv420_host(frames: np.ndarray) -> np.ndarray:
    """Host pack: (..., H, W, 3) u8 BGR → (..., H·3/2, W) u8.  A
    (C, H, W, 3) stack goes through the native pack (``native.yuv420_pack``,
    byte-identical to :func:`_bgr_to_yuv420_numpy`), which raises when its
    library cannot be built; other shapes take the numpy reference."""
    if np.ndim(frames) == 4:
        return native.yuv420_pack(np.asarray(frames))
    return _bgr_to_yuv420_numpy(frames)


def _bgr_to_yuv420_numpy(frames):
    """The numpy reference of the pack (the native pack's oracle)."""
    b = frames[..., 0].astype(np.int32)
    g = frames[..., 1].astype(np.int32)
    r = frames[..., 2].astype(np.int32)
    H, W = frames.shape[-3:-1]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    u = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128
    v = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128

    def sub(c):  # 2×2 mean, rounded
        c = c.reshape(c.shape[:-2] + (H // 2, 2, W // 2, 2))
        return (c.sum(axis=(-3, -1)) + 2) >> 2

    chroma = np.concatenate([sub(u), sub(v)], axis=-1)  # (..., H/2, W)
    packed = np.concatenate([y, chroma], axis=-2)
    return np.clip(packed, 0, 255).astype(np.uint8)


def yuv420_to_bgr_u8(packed: torch.Tensor) -> torch.Tensor:
    """Unpack on the tensor's device: (..., H·3/2, W) u8 → (..., H, W, 3)
    u8 BGR.  Nearest-neighbour chroma upsampling, the BT.601 full-range
    inverse in f32 rounded after every operation, ``torch.round`` (half to
    even), clip."""
    Hp, W = packed.shape[-2:]
    H = Hp * 2 // 3
    y = packed[..., :H, :].to(torch.float32)
    chroma = packed[..., H:, :].to(torch.float32)
    u = chroma[..., :, :W // 2] - 128.0
    v = chroma[..., :, W // 2:] - 128.0
    u, v = _upsample2(u), _upsample2(v)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.round(bgr).clamp(0, 255).to(torch.uint8)


def _upsample2(c: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsampling of the last two dims."""
    *lead, h, w = c.shape
    return c[..., :, None, :, None].expand(*lead, h, 2, w, 2).reshape(
        *lead, 2 * h, 2 * w)
