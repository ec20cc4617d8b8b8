"""Synthetic 4-camera rig with exactly known geometry (host numpy).

The port's own copy of ``vbr_tpu/utils/synthetic.py``: cameras on a circle
around a world-space sphere, silhouettes rendered analytically (a pixel is
on iff its viewing ray passes within r of the centre), and ramp frames.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.utils.config import CameraParams


def look_at_rt(cam_center: np.ndarray, target: np.ndarray, up=(0, 0, 1.0)):
    """World→camera (R, t) for a camera at ``cam_center`` looking at
    ``target`` (OpenCV convention: +z forward, +x right, +y down)."""
    fwd = target - cam_center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    t = -R @ cam_center
    return R, t


def synthetic_cameras(
    num_cameras: int = 4,
    distance: float = 4500.0,
    height: float = -1200.0,
    image_hw: Tuple[int, int] = (486, 644),
    f: float = 490.0,
) -> List[CameraParams]:
    """Undistorted cameras on a circle in the z=height plane, looking at
    the origin."""
    H, W = image_hw
    cams = []
    for i in range(num_cameras):
        ang = 2 * np.pi * i / num_cameras + 0.35
        center = np.array(
            [distance * np.cos(ang), distance * np.sin(ang), height]
        )
        R, t = look_at_rt(center, np.zeros(3), up=(0, 0, -1.0))
        rvec = cam_ops.rodrigues_inverse(R)
        cams.append(
            CameraParams(
                fx=f, fy=f, cx=W / 2.0, cy=H / 2.0,
                rvec_xyz=tuple(rvec), tvec_xyz=tuple(t),
            )
        )
    return cams


def sphere_silhouette_mask(
    cp: CameraParams, center: np.ndarray, radius: float,
    image_hw: Tuple[int, int] = (486, 644),
) -> np.ndarray:
    """Analytic silhouette of a sphere, (H, W) u8 {0, 255}."""
    H, W = image_hw
    R = cam_ops.rodrigues(cp.rvec)
    cam_center = -R.T @ cp.tvec
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    xn = (us - cp.cx) / cp.fx
    yn = (vs - cp.cy) / cp.fy
    dirs_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)
    dirs_world = dirs_cam @ R
    dirs_world /= np.linalg.norm(dirs_world, axis=-1, keepdims=True)
    rel = center - cam_center
    along = dirs_world @ rel
    dist2 = (rel @ rel) - along**2
    mask = (dist2 <= radius * radius) & (along > 0)
    return (mask.astype(np.uint8)) * 255


def synthetic_rig(
    num_cameras: int = 4,
    sphere_center=(100.0, -50.0, -700.0),
    sphere_radius: float = 500.0,
    image_hw: Tuple[int, int] = (486, 644),
):
    """(cameras, masks (C,H,W) u8, frames (C,H,W,3) u8)."""
    cams = synthetic_cameras(num_cameras, image_hw=image_hw)
    center = np.asarray(sphere_center, dtype=np.float64)
    masks = np.stack(
        [sphere_silhouette_mask(cp, center, sphere_radius, image_hw)
         for cp in cams]
    )
    H, W = image_hw
    ramp_u = np.broadcast_to(np.arange(W, dtype=np.uint8), (H, W))
    ramp_v = np.broadcast_to(np.arange(H)[:, None] % 256,
                             (H, W)).astype(np.uint8)
    # the third channel wraps past 255 (from the seventh camera on), as
    # the JAX package's u8 cast did
    frames = np.stack(
        [np.stack([ramp_u, ramp_v,
                   np.full((H, W), (60 + 30 * i) % 256, np.uint8)], -1)
         for i in range(num_cameras)]
    )
    return cams, masks, frames
