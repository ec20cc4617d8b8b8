"""Colour-space transforms with OpenCV's 8-bit conventions.

Counterpart of ``vbr_tpu/ops/color.py::bgr_to_hsv_u8``, bit-exact: the same
int32 fixed-point tables (hsv_shift = 12) and half-to-even rounding
(``torch.round``, like ``jnp.round`` and OpenCV's cvRound).
"""

from __future__ import annotations

import torch


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
