"""Typed configuration of the rig, the voxel grid and the mask stages.

The port's own copy of ``vbr_tpu/utils/config.py``: the dataclasses the
per-frame step reads, the viewer's ``AppConfig`` and
``reference_data_dir``.  Field names, defaults and the canonical voxel
order are identical, so a configuration written for one package means the
same in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Voxel-grid geometry: ``linspace`` over each axis (inclusive ends),
    voxels in canonical (ix, iy, iz) C-order, index = (ix·ny + iy)·nz + iz.
    """

    nx: int = 128
    ny: int = 128
    nz: int = 128
    x_min: float = -512.0
    x_max: float = 1024.0
    y_min: float = -1024.0
    y_max: float = 1024.0
    z_min: float = -2048.0
    z_max: float = 512.0

    @property
    def num_voxels(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    def axis_ranges(self):
        """Per-axis sample coordinates (numpy float64)."""
        xs = np.linspace(self.x_min, self.x_max, self.nx)
        ys = np.linspace(self.y_min, self.y_max, self.ny)
        zs = np.linspace(self.z_min, self.z_max, self.nz)
        return xs, ys, zs

    def voxel_points(self) -> np.ndarray:
        """(N, 3) float64 world-mm voxel centres in canonical order."""
        xs, ys, zs = self.axis_ranges()
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Calibrated pinhole camera: intrinsics, 5 distortion coefficients,
    axis-angle pose.  Stored as floats/tuples (hashable); ``.K``, ``.dist``,
    ``.rvec``, ``.tvec`` give float64 numpy views."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    rvec_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    tvec_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def dist(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3],
                        dtype=np.float64)

    @property
    def rvec(self) -> np.ndarray:
        return np.array(self.rvec_xyz, dtype=np.float64)

    @property
    def tvec(self) -> np.ndarray:
        return np.array(self.tvec_xyz, dtype=np.float64)

    @staticmethod
    def from_arrays(K, dist, rvec, tvec) -> "CameraParams":
        K = np.asarray(K, dtype=np.float64).reshape(3, 3)
        dist = np.asarray(dist, dtype=np.float64).reshape(-1)
        d = np.zeros(5)
        d[: dist.shape[0]] = dist[:5]
        rvec = np.asarray(rvec, dtype=np.float64).reshape(-1)
        tvec = np.asarray(tvec, dtype=np.float64).reshape(-1)
        return CameraParams(
            fx=float(K[0, 0]), fy=float(K[1, 1]),
            cx=float(K[0, 2]), cy=float(K[1, 2]),
            k1=float(d[0]), k2=float(d[1]), p1=float(d[2]),
            p2=float(d[3]), k3=float(d[4]),
            rvec_xyz=tuple(float(v) for v in rvec[:3]),
            tvec_xyz=tuple(float(v) for v in tvec[:3]),
        )


@dataclasses.dataclass(frozen=True)
class MaskParams:
    """Foreground-mask post-processing knobs of one camera."""

    figure_threshold: float = 5000.0
    inner_threshold: float = 115.0
    opening_pre: bool = False
    closing_pre: bool = False
    opening_post: bool = False
    closing_post: bool = False


# Per-camera production values of the reference rig.
DEFAULT_MASK_PARAMS: Tuple[MaskParams, ...] = (
    MaskParams(5000, 115, False, False, True, True),
    MaskParams(5000, 115, False, False, True, True),
    MaskParams(5000, 175, False, True, True, True),
    MaskParams(5000, 115, False, False, False, True),
)


@dataclasses.dataclass(frozen=True)
class MOGParams:
    """Mixture-of-Gaussians background model hyperparameters (50
    mixtures, background ratio 0.9, HSV colour space)."""

    n_mixtures: int = 50
    bg_ratio: float = 0.9
    noise_sigma: float = 15.0
    history: int = 134
    use_hsv: bool = True
    var_init: float = 225.0
    var_min: float = 0.0
    match_sigma: float = 2.5


@dataclasses.dataclass(frozen=True)
class RigConfig:
    """A multi-camera capture rig + reconstruction settings."""

    num_cameras: int = 4
    image_height: int = 486
    image_width: int = 644
    views_threshold: int = 4  # voxel kept iff visible in >= this many views
    color_camera: int = 1  # 0-based index of the camera giving voxel colours
    scaling_factor: float = 64.0  # world mm → viewer units
    chessboard_rows: int = 6
    chessboard_cols: int = 8
    chessboard_square_mm: float = 115.0


@dataclasses.dataclass(frozen=True)
class AppConfig:
    """Viewer/application settings (reference ``config.json:1-13``)."""

    window_width: int = 1280
    window_height: int = 720
    world_width: int = 128
    world_height: int = 64
    world_depth: int = 128
    sampling_level: int = 4
    near: float = 0.1
    far: float = 500.0
    debug_mode: bool = False

    @staticmethod
    def load(path: str) -> "AppConfig":
        """The settings of a ``config.json``; a key it lacks keeps its
        default."""
        with open(path) as f:
            raw = json.load(f)
        return AppConfig(**{
            f.name: raw.get(f.name, f.default)
            for f in dataclasses.fields(AppConfig)})


def reference_data_dir() -> str:
    """The reference dataset's directory (4-camera videos + calibration
    XML): ``$VBR_DATA_DIR``, else ``data/`` at the repository's root.  The
    JAX package also looks in one fixed directory outside the repository;
    the port reads nothing outside its checkout unless told to."""
    for cand in (
        os.environ.get("VBR_DATA_DIR", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "data"),
    ):
        if cand and os.path.isdir(cand):
            return os.path.abspath(cand)
    raise FileNotFoundError("no data directory found; set VBR_DATA_DIR")
