"""Calibration validation: AR drawings and reprojection checks.

Counterpart of ``vbr_tpu/pipelines/validation.py``: world-origin axes, a
cube, the detected corners drawn onto a BGR u8 frame in place (plain numpy
rasterization, the same pixels as the JAX package's), and the mean
reprojection error, all on the host in f64; and
``test_camera_parameters_with_image``, the AR check drawn on a
checkerboard video frame (decoded by ``utils/video.py``) and written as a
JPEG through PIL.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from vbr_tpu_torch.ops import camera as cam_ops


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2):
    """A thick line on a BGR u8 image (in place)."""
    H, W = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(max(abs(p1 - p0).max(), 1)) + 1
    ts = np.linspace(0.0, 1.0, n)
    pts = p0[None] + ts[:, None] * (p1 - p0)[None]
    r = thickness // 2
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            u = np.clip(pts[:, 0].astype(int) + du, 0, W - 1)
            v = np.clip(pts[:, 1].astype(int) + dv, 0, H - 1)
            img[v, u] = color
    return img


def _project(pts, K, dist, rvec, tvec):
    return cam_ops.project_points(pts, np.asarray(rvec).ravel(),
                                  np.asarray(tvec).ravel(), K,
                                  np.asarray(dist).ravel())


def draw_axes(img: np.ndarray, K, dist, rvec, tvec,
              axis_length: float = 230.0):
    """World-origin axes: X blue, Y green, Z red (BGR)."""
    pts = np.array([[0.0, 0, 0], [axis_length, 0, 0], [0, axis_length, 0],
                    [0, 0, -axis_length]])
    uv = _project(pts, K, dist, rvec, tvec)
    o = uv[0]
    for end, color in zip(uv[1:], ((255, 0, 0), (0, 255, 0), (0, 0, 255))):
        draw_line(img, o, end, color, 3)
    return img


def draw_cube(img: np.ndarray, K, dist, rvec, tvec, size: float = 230.0):
    """A wireframe cube standing on the chessboard plane."""
    s = size
    corners = np.array([
        [0, 0, 0], [s, 0, 0], [s, s, 0], [0, s, 0],
        [0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s],
    ], dtype=np.float64)
    uv = _project(corners, K, dist, rvec, tvec)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        draw_line(img, uv[a], uv[b], (0, 255, 255), 2)
    return img


def draw_circle(img: np.ndarray, center, radius: int, color,
                thickness: int = 2):
    """A circle outline on a BGR u8 image (in place)."""
    H, W = img.shape[:2]
    cx, cy = float(center[0]), float(center[1])
    n = max(int(2 * np.pi * radius), 8)
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    for rr in range(max(radius - thickness // 2, 1),
                    radius + thickness // 2 + 1):
        u = np.clip((cx + rr * np.cos(ang)).astype(int), 0, W - 1)
        v = np.clip((cy + rr * np.sin(ang)).astype(int), 0, H - 1)
        img[v, u] = color
    return img


def draw_chessboard_corners(img: np.ndarray, pts: np.ndarray,
                            board: Tuple[int, int], found: bool = True):
    """``cv2.drawChessboardCorners``-style overlay (in place): the corners
    joined row by row in a per-row rainbow colour, a circle at each."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    if not found or len(pts) == 0:
        return img
    bw, _ = board
    rainbow = [
        (0, 0, 255), (0, 128, 255), (0, 255, 255), (0, 255, 0),
        (255, 128, 0), (255, 0, 0), (255, 0, 255), (128, 0, 255),
    ]
    for i in range(len(pts) - 1):
        draw_line(img, pts[i], pts[i + 1], rainbow[(i // bw) % len(rainbow)],
                  1)
    for i, p in enumerate(pts):
        draw_circle(img, p, 4, rainbow[(i // bw) % len(rainbow)], 1)
    return img


def test_camera_parameters_with_image(
    data_dir: str,
    camera: int,
    out_path: str,
    draw: str = "axes",
    frame_index: int = 0,
):
    """Draw the AR check for one camera (``draw="axes"`` or a cube) on
    frame ``frame_index`` of its ``checkerboard.avi``, save it as a JPEG
    and return the frame (camera_calibration.py:824-864 equivalent)."""
    from vbr_tpu_torch.utils import video as vio
    from vbr_tpu_torch.utils import xmlio

    cam_dir = os.path.join(data_dir, f"cam{camera}")
    K, dist, rvec, tvec = xmlio.load_camera_config(cam_dir)
    frame = vio.get_frame(os.path.join(cam_dir, "checkerboard.avi"),
                          frame_index)
    if frame is None:
        raise FileNotFoundError("no checkerboard frame")
    if draw == "axes":
        draw_axes(frame, K, dist, rvec, tvec)
    else:
        draw_cube(frame, K, dist, rvec, tvec)
    vio.write_jpeg(out_path, frame)
    return frame


def reprojection_error(obj_pts, img_pts, K, dist, rvec, tvec) -> float:
    """Mean L2 reprojection error in pixels."""
    uv = _project(np.asarray(obj_pts, np.float64), np.asarray(K), dist, rvec,
                  tvec)
    return float(np.linalg.norm(uv - np.asarray(img_pts).reshape(-1, 2),
                                axis=1).mean())
