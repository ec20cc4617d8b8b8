"""Textured visual hull: per-voxel colour from the nearest non-occluded
camera.

Counterpart of ``vbr_tpu/ops/texturing.py``.  The reference colours every
voxel from camera 2 (assignment.py:133), which paints the person's back
with their front.  Here:

  1. each camera gets a *depth map* of the carved occupancy: every
     occupied voxel projects to its precomputed pixel, and a scatter-min
     over camera-space depth keeps the nearest occupied depth per pixel;
  2. a voxel is visible to camera c iff its own depth is within a
     tolerance of that pixel's depth-map value;
  3. each voxel takes its colour from the nearest visible camera; a voxel
     visible nowhere (interior) from the nearest camera whose image it
     projects into.

The static geometry (depths, pixel indices) is built once on the host in
float64, as the JAX package builds it; the per-frame work is one
scatter-min and a few gathers per camera on the tables' device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.utils.config import CameraParams, GridConfig
from vbr_tpu_torch.utils.device import resolve_device

_FAR = 3.4e38  # f32 "no occupied voxel" depth, the JAX package's fill


class TexturingTables(NamedTuple):
    valid: torch.Tensor  # (C, N) bool
    lin_idx: torch.Tensor  # (C, N) i32
    depth: torch.Tensor  # (C, N) f32 camera-space z (mm)
    image_hw: Tuple[int, int]


def build_texturing_tables(
    cameras: Sequence[CameraParams],
    grid: GridConfig,
    image_hw: Tuple[int, int],
    device="cuda",
) -> TexturingTables:
    """Projection tables + per-voxel camera-space depth (float64 host),
    moved to ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    H, W = image_hw
    pts = grid.voxel_points()
    valids, idxs, depths = [], [], []
    for cp in cameras:
        R = cam_ops.rodrigues(cp.rvec)
        Xc = pts @ R.T + cp.tvec
        uv = cam_ops.project_points(pts, cp.rvec, cp.tvec, cp.K, cp.dist)
        x, y = uv[:, 0], uv[:, 1]
        valid = (y >= 0) & (y < H) & (x >= 0) & (x < W) & (Xc[:, 2] > 0)
        lin = np.where(
            valid,
            np.trunc(y).astype(np.int64) * W + np.trunc(x).astype(np.int64),
            0,
        ).astype(np.int32)
        valids.append(valid)
        idxs.append(lin)
        depths.append(Xc[:, 2].astype(np.float32))
    return TexturingTables(
        valid=torch.from_numpy(np.stack(valids)).to(device),
        lin_idx=torch.from_numpy(np.stack(idxs)).to(device),
        depth=torch.from_numpy(np.stack(depths)).to(device),
        image_hw=(H, W),
    )


def depth_maps(
    occupancy: torch.Tensor,  # (N,) bool
    tables_valid: torch.Tensor,
    tables_lin: torch.Tensor,
    tables_depth: torch.Tensor,
    *,
    image_hw: Tuple[int, int],
) -> torch.Tensor:
    """(C, H·W) f32 nearest-occupied-voxel depth per pixel (3.4e38 where
    none)."""
    H, W = image_hw
    d = torch.where(occupancy[None] & tables_valid, tables_depth, _FAR)
    out = torch.full((tables_depth.shape[0], H * W), _FAR,
                     dtype=torch.float32, device=tables_depth.device)
    return out.scatter_reduce_(1, tables_lin.long(), d, "amin",
                               include_self=True)


def textured_colors(
    occupancy: torch.Tensor,  # (N,) bool
    images: torch.Tensor,  # (C, H, W, 3) u8 BGR
    tables_valid: torch.Tensor,
    tables_lin: torch.Tensor,
    tables_depth: torch.Tensor,
    *,
    image_hw: Tuple[int, int],
    depth_tolerance: float = 40.0,  # mm (≈ voxel diagonal at 128³)
):
    """Per-voxel colours from the nearest non-occluded camera.

    Returns (colors (N, 3) u8 BGR, cam_choice (N,) i8: index of the chosen
    camera, −1 where the voxel is not occupied).  Among equally near
    cameras the lowest index wins (``torch.argmin``'s first minimum)."""
    C = images.shape[0]
    dmaps = depth_maps(occupancy, tables_valid, tables_lin, tables_depth,
                       image_hw=image_hw)  # (C, HW)
    lin = tables_lin.long()
    surf = dmaps.gather(1, lin)  # nearest occupied depth at my pixel
    visible = tables_valid & (tables_depth <= surf + depth_tolerance)
    cols = images.reshape(C, -1, 3).gather(
        1, lin[..., None].expand(-1, -1, 3))  # (C, N, 3)

    # nearest visible camera; fall back to the nearest valid camera
    d_vis = torch.where(visible, tables_depth, _FAR)
    d_any = torch.where(tables_valid, tables_depth, _FAR)
    choice = torch.where(visible.any(dim=0), torch.argmin(d_vis, dim=0),
                         torch.argmin(d_any, dim=0))  # (N,)
    colors = cols.gather(0, choice[None, :, None].expand(1, -1, 3))[0]
    cam_choice = torch.where(occupancy, choice.to(torch.int8), -1)
    return colors, cam_choice
