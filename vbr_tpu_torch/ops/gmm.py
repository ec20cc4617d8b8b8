"""Frozen mixture-of-Gaussians background apply.

Counterpart of the apply side of ``vbr_tpu/ops/gmm.py``: ``MOGState``
(schema 2: ``var`` is the per-mixture total variance Σv, slots in OpenCV
storage order), ``apply_frozen`` (the full-state reference), and the
prefix compression ``compress_frozen`` + ``apply_frozen_compressed`` that
the per-frame step runs.  Training (and its kernel) is not ported yet.

The compressed apply is exact: a pixel is background iff some slot
j < B = min(n_lead, k_fg) matches (‖x − μⱼ‖² < 6.25·Σvⱼ), so only the
first Ke = max(B) slots are kept.  ``compress_frozen`` runs on the host in
float32 numpy with a sequential cumulative weight sum, the order OpenCV
uses, so the per-pixel bound B does not depend on a device's scan order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vbr_tpu_torch.utils.config import MOGParams

FLT_EPSILON = np.float32(1.1920929e-07)


class MOGState(NamedTuple):
    """Apply-facing mixture state, leading dims = pixel grid (H, W)."""

    weight: torch.Tensor  # (..., K) f32
    mean: torch.Tensor  # (..., K, 3) f32
    var: torch.Tensor  # (..., K) f32 — total variance Σ_channels
    nframes: torch.Tensor  # () int32


class FrozenMOGState(NamedTuple):
    """Decision-sufficient prefix of a frozen MOG model."""

    mean: torch.Tensor  # (..., Ke, 3) f32
    thr: torch.Tensor  # (..., Ke) f32 — 6.25·Σv per slot
    bcount: torch.Tensor  # (...,) i32 — per-pixel decision-slot count B


def _match_d2(x, mean):
    """‖x − μ‖² per slot, summed in the JAX package's order."""
    diff = x[..., None, :] - mean
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            + diff[..., 2] * diff[..., 2])


def _decision_bound(weight: np.ndarray, bg_ratio: float) -> np.ndarray:
    """Per-pixel B = min(n_lead, k_fg) from (..., K) float32 weights."""
    K = weight.shape[-1]
    invalid = weight < FLT_EPSILON
    n_lead = np.where(invalid.any(axis=-1), np.argmax(invalid, axis=-1), K)
    cumw = np.cumsum(weight, axis=-1, dtype=np.float32)  # sequential
    over = cumw > np.float32(bg_ratio)
    k_fg = np.where(over.any(axis=-1), np.argmax(over, axis=-1) + 1, 0)
    return np.minimum(n_lead, k_fg).astype(np.int32)


def apply_frozen(state: MOGState, frame: torch.Tensor,
                 params: MOGParams) -> torch.Tensor:
    """Full-state frozen inference: (H, W, 3) u8 → (H, W) u8 {0, 255}."""
    x = frame.to(torch.float32)
    w = state.weight
    K = w.shape[-1]
    invalid = w < float(FLT_EPSILON)
    n_lead = torch.where(invalid.any(dim=-1),
                         torch.argmax(invalid.to(torch.int8), dim=-1), K)
    k_idx = torch.arange(K, device=w.device)
    in_prefix = k_idx < n_lead[..., None]
    vt = np.float32(params.match_sigma**2)
    matched = in_prefix & (_match_d2(x, state.mean) < float(vt) * state.var)
    any_match = matched.any(dim=-1)
    first = torch.argmax(matched.to(torch.int8), dim=-1)
    cumw = torch.cumsum(w, dim=-1)
    over = cumw > float(np.float32(params.bg_ratio))
    k_fg = torch.where(over.any(dim=-1),
                       torch.argmax(over.to(torch.int8), dim=-1) + 1, 0)
    is_bg = any_match & (first < k_fg)
    return torch.where(is_bg, 0, 255).to(torch.uint8)


def compress_frozen(state: MOGState, params: MOGParams,
                    k_eff: Optional[int] = None):
    """MOGState → (FrozenMOGState on the state's device, Ke).  ``k_eff``
    forces the prefix length; default = max over pixels of B (≥ 1)."""
    w = state.weight.detach().cpu().numpy().astype(np.float32)
    bcount = _decision_bound(w, params.bg_ratio)
    if k_eff is None:
        k_eff = max(int(bcount.max(initial=0)), 1)
    vt = np.float32(params.match_sigma**2)
    dev = state.weight.device
    return (
        FrozenMOGState(
            mean=state.mean[..., :k_eff, :].to(torch.float32),
            thr=float(vt) * state.var[..., :k_eff].to(torch.float32),
            bcount=torch.from_numpy(bcount).to(dev),
        ),
        k_eff,
    )


def apply_frozen_compressed(fz: FrozenMOGState,
                            frame: torch.Tensor) -> torch.Tensor:
    """Frozen inference on the compressed prefix; (..., 3) u8 → (...) u8
    {0, 255}, bitwise equal to :func:`apply_frozen` on the full state."""
    x = frame.to(torch.float32)
    k_idx = torch.arange(fz.thr.shape[-1], device=fz.thr.device)
    matched = (k_idx < fz.bcount[..., None]) & (_match_d2(x, fz.mean) < fz.thr)
    return torch.where(matched.any(dim=-1), 0, 255).to(torch.uint8)
