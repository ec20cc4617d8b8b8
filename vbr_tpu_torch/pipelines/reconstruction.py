"""End-to-end visual-hull reconstruction, and the reference's viewer-seam
helpers.

Counterpart of ``vbr_tpu/pipelines/reconstruction.py``: ``load_rig`` reads
a rig's per-camera ``cam{i}/config.xml``; ``Reconstructor`` holds the
projection tables of one rig and grid on a device (or, for grids whose
tables would not fit, the cameras and voxel centres of the fused carve)
and carves a frame's masks; ``generate_grid``, ``get_cam_positions`` and
``get_cam_rotation_matrices`` are three of the reference's four viewer
functions (``apps/assignment_api.py`` adds ``set_voxel_positions``);
``write_ply`` dumps a point cloud.  Camera math is host f64 numpy with the
JAX package's operation order, so positions and rotations are the same
numbers in both packages.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.utils import xmlio
from vbr_tpu_torch.utils.config import CameraParams, GridConfig, RigConfig
from vbr_tpu_torch.utils.device import resolve_device

BLOCK_SIZE = 1.0


def load_rig(data_dir: str, num_cameras: int = 4) -> List[CameraParams]:
    """Load per-camera calibration artifacts (``data_dir/cam*/config.xml``)."""
    cams = []
    for i in range(1, num_cameras + 1):
        K, dist, rvec, tvec = xmlio.load_camera_config(
            os.path.join(data_dir, f"cam{i}"))
        cams.append(CameraParams.from_arrays(K, dist, rvec, tvec))
    return cams


class Reconstructor:
    """Per-rig reconstruction on ``device``: with ``use_tables`` the
    projection tables (built on the device, exact) and per frame the table
    carve (``carve.carve_from_tables``); without, no table, and per frame
    the f32 fused carve (``carve.carve_fused``), for very large grids."""

    def __init__(
        self,
        cameras: Sequence[CameraParams],
        grid: GridConfig,
        rig: RigConfig = RigConfig(),
        use_tables: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cameras = list(cameras)
        self.grid = grid
        self.rig = rig
        self.use_tables = use_tables
        image_hw = (rig.image_height, rig.image_width)
        if use_tables:
            self.tables = carve_ops.build_projection_tables(
                self.cameras, grid, image_hw, device=self.device)
        else:
            self.tables = None
            self._pose = carve_ops._pose_arrays(self.cameras, self.device)
            self._points = carve_ops.voxel_points_f32(grid, self.device)

    def carve_frame(self, masks, images):
        """masks (C, H, W) u8, images (C, H, W, 3) u8 BGR (numpy or torch)
        → (occupancy (N,) bool, colors (N, 3) u8) on the device."""
        masks, images = self._on_device(masks), self._on_device(images)
        kw = dict(views_threshold=self.rig.views_threshold,
                  color_camera=self.rig.color_camera)
        if self.use_tables:
            return carve_ops.carve_from_tables(
                masks, images, self.tables.valid, self.tables.lin_idx, **kw)
        return carve_ops.carve_fused(
            masks, images, self._points, *self._pose,
            image_hw=(self.rig.image_height, self.rig.image_width), **kw)

    def carve_frame_compact(self, masks, images):
        """Carve + host compaction into viewer positions and colours."""
        occ, colors = self.carve_frame(masks, images)
        return carve_ops.compact_voxels(occ, colors, self.grid,
                                        self.rig.scaling_factor)

    def occupancy_volume(self, masks, images) -> np.ndarray:
        """Carve and reshape occupancy into a (nx, ny, nz) bool volume."""
        occ, _ = self.carve_frame(masks, images)
        return carve_ops.to_host(occ).reshape(self.grid.shape)

    def _on_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.uint8))
        return x.to(self.device)


# ---------------------------------------------------------------------------
# The reference's viewer functions
# ---------------------------------------------------------------------------


def generate_grid(width: int, depth: int):
    """Checkerboard floor tile positions and colours."""
    data, colors = [], []
    for x in range(width):
        for z in range(depth):
            data.append(
                [x * BLOCK_SIZE - width / 2, -BLOCK_SIZE, z * BLOCK_SIZE - depth / 2]
            )
            colors.append([1.0, 1.0, 1.0] if (x + z) % 2 == 0 else [0, 0, 0])
    return data, colors


def get_cam_positions(cameras: Sequence[CameraParams],
                      square_size_mm: float = 115.0):
    """Camera centres in viewer coordinates: C = -Rᵀ t scaled by
    1/square_size, then the OpenCV → OpenGL axis swap (x, -z, y); and one
    colour per camera."""
    positions = []
    for cp in cameras:
        R = cam_ops.rodrigues(cp.rvec)
        C = (-R.T @ cp.tvec) / square_size_mm
        positions.append([C[0], -C[2], C[1]])
    palette = [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [1.0, 1.0, 0]]
    return positions, [palette[i % 4] for i in range(len(cameras))]


def get_cam_rotation_matrices(cameras: Sequence[CameraParams]) -> List[np.ndarray]:
    """Camera rotations as 4×4 OpenGL matrices: R's columns (0, 2, 1) — the
    Y/Z columns swapped — then rotated 90° about Y with Y flipped."""
    rot90y = np.array(
        [[0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 0, 1]], dtype=np.float64
    )
    flip_y = np.diag([1.0, -1.0, 1.0, 1.0])
    axes_conversion = rot90y @ flip_y
    out = []
    for cp in cameras:
        R = cam_ops.rodrigues(cp.rvec)
        M = np.eye(4)
        M[:3, 0] = R[:, 0]
        M[:3, 1] = R[:, 2]
        M[:3, 2] = R[:, 1]
        out.append(axes_conversion @ M)
    return out


# ---------------------------------------------------------------------------
# Artifact output
# ---------------------------------------------------------------------------


def write_ply(path: str, positions: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Write a point cloud as ASCII PLY (colours in [0, 1] → u8)."""
    positions = np.asarray(positions, dtype=np.float32)
    n = positions.shape[0]
    has_color = colors is not None
    if has_color:
        rgb255 = np.clip(np.asarray(colors, dtype=np.float64) * 255.0, 0, 255).astype(
            np.uint8
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            line = f"{positions[i,0]:.4f} {positions[i,1]:.4f} {positions[i,2]:.4f}"
            if has_color:
                line += f" {rgb255[i,0]} {rgb255[i,1]} {rgb255[i,2]}"
            f.write(line + "\n")
