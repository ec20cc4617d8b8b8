"""Voxel carving on the plain table path.

Counterpart of ``vbr_tpu/ops/carve.py``: the float64 host projection
tables (``_build_tables_f64``, the exactness oracle: float bounds check,
truncate-toward-zero pixel index), the per-frame table carve
``carve_from_tables``, its loop over a batch of frames
``carve_frames_batched`` and the host viewer compaction
``compact_voxels``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.utils.config import CameraParams, GridConfig


class ProjectionTables(NamedTuple):
    """Static per-rig carving tables.

    valid:    (C, N) bool   — projection inside the image (float-coord test)
    lin_idx:  (C, N) int32  — truncated y*W + x (0 where invalid)
    """

    valid: torch.Tensor
    lin_idx: torch.Tensor
    image_hw: Tuple[int, int]


def _build_tables_f64(cameras: Sequence[CameraParams], grid: GridConfig,
                      image_hw) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-host float64 tables: (valid (C, N) bool, lin_idx (C, N) i32)."""
    H, W = image_hw
    pts = grid.voxel_points()
    valids, idxs = [], []
    for cp in cameras:
        uv = cam_ops.project_points(pts, cp.rvec, cp.tvec, cp.K, cp.dist)
        x, y = uv[:, 0], uv[:, 1]
        valid = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        ix = np.trunc(x).astype(np.int64)
        iy = np.trunc(y).astype(np.int64)
        lin = np.where(valid, iy * W + ix, 0).astype(np.int32)
        valids.append(valid)
        idxs.append(lin)
    return np.stack(valids), np.stack(idxs)


def build_projection_tables(cameras: Sequence[CameraParams], grid: GridConfig,
                            image_hw, device="cpu") -> ProjectionTables:
    """The f64 host tables, moved to ``device``."""
    valid, lin = _build_tables_f64(cameras, grid, image_hw)
    return ProjectionTables(
        valid=torch.from_numpy(valid).to(device),
        lin_idx=torch.from_numpy(lin).to(device),
        image_hw=tuple(image_hw),
    )


def carve_from_tables(
    masks: torch.Tensor,  # (C, H, W) u8 foreground masks
    images: torch.Tensor,  # (C, H, W, 3) u8 BGR frames
    valid: torch.Tensor,  # (C, N) bool
    lin_idx: torch.Tensor,  # (C, N) int32
    *,
    views_threshold: int = 4,
    color_camera: int = 1,
):
    """Per-frame carve: C mask gathers + view count + colour gather.

    Returns (occupancy (N,) bool, colors (N, 3) u8 BGR).  Like the JAX
    table path, an invalid projection of the colour camera reads pixel
    (0, 0) (only occupied voxels' colours are ever consumed)."""
    C = masks.shape[0]
    masks_flat = masks.reshape(C, -1)
    lin = lin_idx.long()
    count = torch.zeros(valid.shape[1], dtype=torch.int32, device=masks.device)
    for c in range(C):
        count += (valid[c] & (masks_flat[c][lin[c]] > 0)).to(torch.int32)
    occupancy = count >= views_threshold
    colors = images[color_camera].reshape(-1, 3)[lin[color_camera]]
    return occupancy, colors


def carve_frames_batched(
    masks: torch.Tensor,  # (F, C, H, W) u8
    images: torch.Tensor,  # (F, C, H, W, 3) u8
    valid: torch.Tensor,
    lin_idx: torch.Tensor,
    *,
    views_threshold: int = 4,
    color_camera: int = 1,
):
    """:func:`carve_from_tables` over a batch of F frames →
    (occupancy (F, N) bool, colors (F, N, 3) u8)."""
    outs = [carve_from_tables(m, im, valid, lin_idx,
                              views_threshold=views_threshold,
                              color_camera=color_camera)
            for m, im in zip(masks, images)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([c for _, c in outs]))


def compact_voxels(occupancy, colors, grid: GridConfig,
                   scaling_factor: float = 64.0):
    """Host compaction into the viewer contract: truncated world positions
    with the (x, -z, y)/scale axis swap, and BGR→RGB colours in [0, 1].

    Returns (positions (M, 3) float32, colors (M, 3) float32) numpy."""
    occupancy = to_host(occupancy).astype(bool)
    return viewer_arrays(grid.voxel_points()[occupancy],
                         to_host(colors)[occupancy], scaling_factor)


def viewer_arrays(points, colors_bgr, scaling_factor: float = 64.0):
    """(M, 3) world points + (M, 3) u8 BGR → viewer positions (int()
    truncation, then (x, -z, y) / scale) and RGB colours in [0, 1]."""
    kept = np.trunc(points)
    positions = np.stack(
        [
            kept[:, 0] / scaling_factor,
            -(kept[:, 2] / scaling_factor),
            kept[:, 1] / scaling_factor,
        ],
        axis=-1,
    ).astype(np.float32)
    rgb = colors_bgr[:, ::-1].astype(np.float32) / 255.0
    return positions, rgb


def to_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
