"""Pinhole camera math: float64 numpy on the host, and tensors.

Counterpart of ``vbr_tpu/ops/camera.py`` (``rodrigues``,
``rodrigues_inverse``, ``distort_normalized``, ``project_points_rt``,
``project_points``, ``undistort_points``, ``homography_dlt``,
``apply_homography``, ``perspective_transform_4pt``), with the same
operation order, so the f64 projection tables the carve reads are
bit-identical to the JAX package's host build.

Every function but ``rodrigues_inverse`` also takes tensors (as
``vbr_tpu``'s take ``xp=jnp``) and computes in the input's dtype on its
device: the f32 projection of the device table builds, one eager
elementwise operation at a time (no matmul, so no TF32, and no fused
multiply-add), and the f64 residuals of the calibration solver, which
``torch.func`` differentiates (no in-place operations, no host syncs).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rodrigues(rvec):
    """Axis-angle rotation vector (3,) → rotation matrix (3, 3): f64 numpy,
    or a tensor of ``rvec``'s dtype and device for a tensor ``rvec``."""
    if isinstance(rvec, torch.Tensor):
        return _rodrigues_tensor(rvec)
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta2 = rvec[0] * rvec[0] + rvec[1] * rvec[1] + rvec[2] * rvec[2]
    theta = np.sqrt(theta2)
    safe = np.where(theta > 0, theta, 1.0)
    k = rvec / safe
    zero = np.zeros(())
    K = np.stack(
        [
            np.stack([zero, -k[2], k[1]]),
            np.stack([k[2], zero, -k[0]]),
            np.stack([-k[1], k[0], zero]),
        ]
    )
    eye = np.eye(3, dtype=K.dtype)
    kkT = k[:, None] * k[None, :]
    R = eye + np.sin(theta) * K + (1.0 - np.cos(theta)) * (kkT - eye)
    R0 = eye + K * safe
    return np.where(theta > 1e-12, R, R0)


def _rodrigues_tensor(rvec: torch.Tensor) -> torch.Tensor:
    """:func:`rodrigues` on a tensor, elementwise (K² as kkᵀ − I)."""
    rvec = rvec.reshape(3)
    theta2 = rvec[0] * rvec[0] + rvec[1] * rvec[1] + rvec[2] * rvec[2]
    theta = torch.sqrt(theta2)
    safe = torch.where(theta > 0, theta, torch.ones_like(theta))
    k = rvec / safe
    zero = torch.zeros_like(theta)
    K = torch.stack(
        [
            torch.stack([zero, -k[2], k[1]]),
            torch.stack([k[2], zero, -k[0]]),
            torch.stack([-k[1], k[0], zero]),
        ]
    )
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    kkT = k[:, None] * k[None, :]
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (kkT - eye)
    R0 = eye + K * safe
    return torch.where(theta > 1e-12, R, R0)


def rodrigues_inverse(R) -> np.ndarray:
    """Rotation matrix (3, 3) → axis-angle vector (3,), handling θ near 0
    and near π the way ``cv2.Rodrigues`` does."""
    R = np.asarray(R, dtype=np.float64).reshape(3, 3)
    tr = np.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    v = np.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_theta = np.sin(theta)
    generic = v * (theta / np.where(np.abs(sin_theta) > 1e-7,
                                    2.0 * sin_theta, 1.0))
    small = v * 0.5
    S = (R + np.eye(3)) * 0.5
    k = np.sqrt(np.clip(np.stack([S[0, 0], S[1, 1], S[2, 2]]), 0.0, None))
    kx = k[0]
    ky = k[1] * np.sign(np.where(S[0, 1] >= 0, 1.0, -1.0))
    kz = k[2] * np.sign(np.where(S[0, 2] >= 0, 1.0, -1.0))
    ky = np.where(kx > 1e-6, ky, k[1])
    kz = np.where(kx > 1e-6, kz,
                  k[2] * np.sign(np.where(S[1, 2] >= 0, 1.0, -1.0)))
    axis_pi = np.stack([kx, ky, kz])
    norm = np.sqrt(kx * kx + ky * ky + kz * kz)
    axis_pi = axis_pi / np.where(norm > 0, norm, 1.0)
    near_pi = axis_pi * theta
    out = np.where(theta < 1e-6, small, generic)
    return np.where(np.abs(sin_theta) < 1e-7,
                    np.where(theta > 1.0, near_pi, small), out)


def distort_normalized(xn, yn, dist):
    """OpenCV's 5-coefficient (k1, k2, p1, p2, k3) distortion polynomial."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy2 = 2.0 * xn * yn
    xd = xn * radial + p1 * xy2 + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + p2 * xy2
    return xd, yd


def project_points_rt(points, R, tvec, K, dist):
    """World points (..., 3) → pixels (..., 2) with a rotation matrix:
    X_cam = R·X + t → perspective divide → distortion → K.  The rotation
    is applied elementwise; tensors in give a tensor out."""
    if isinstance(points, torch.Tensor):
        tvec, stack = tvec.reshape(3), torch.stack
    else:
        points = np.asarray(points)
        tvec, stack = np.reshape(tvec, (3,)), np.stack
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    Xx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + tvec[0]
    Xy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + tvec[1]
    Xz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + tvec[2]
    inv_z = 1.0 / Xz
    xd, yd = distort_normalized(Xx * inv_z, Xy * inv_z, dist)
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return stack([u, v], axis=-1)


def project_points(points, rvec, tvec, K, dist):
    """World points (..., 3) → pixels (..., 2) from an axis-angle pose
    (all tensors, or host arrays)."""
    R = rodrigues(rvec)
    if not isinstance(tvec, torch.Tensor):
        tvec = np.asarray(tvec)
    return project_points_rt(points, R, tvec.reshape(3), K, dist)


def undistort_points(uv, K, dist, num_iters: int = 8):
    """Invert the distortion: pixels (..., 2) → normalized undistorted
    coordinates (..., 2) by ``num_iters`` fixed-point rounds (as
    ``cv2.undistortPoints``).  A tensor ``uv`` gives a tensor of its dtype
    (``K`` and ``dist`` as host arrays or tensors of the same dtype)."""
    if isinstance(uv, torch.Tensor):
        stack = torch.stack
    else:
        uv, stack = np.asarray(uv), np.stack
    xd = (uv[..., 0] - K[0, 2]) / K[0, 0]
    yd = (uv[..., 1] - K[1, 2]) / K[1, 1]
    xn, yn = xd, yd
    for _ in range(num_iters):
        xe, ye = distort_normalized(xn, yn, dist)
        xn = xn + (xd - xe)
        yn = yn + (yd - ye)
    return stack([xn, yn], axis=-1)


def _normalization_transform(pts):
    """Hartley normalization: the similarity T for which T·pts has zero
    mean and √2 mean distance from it."""
    if isinstance(pts, torch.Tensor):
        mean = pts.mean(dim=0)
        centered = pts - mean
        spread = torch.sqrt((centered * centered).sum(dim=1)).mean()
        scale = math.sqrt(2.0) / torch.clamp(spread, min=1e-12)
        zero, one = torch.zeros_like(scale), torch.ones_like(scale)
        stack = torch.stack
    else:
        mean = np.mean(pts, axis=0)
        centered = pts - mean
        scale = np.sqrt(2.0) / np.maximum(
            np.mean(np.sqrt(np.sum(centered * centered, axis=1))), 1e-12)
        zero, one = np.zeros_like(scale), np.ones_like(scale)
        stack = np.stack
    return stack([
        stack([scale, zero, -scale * mean[0]]),
        stack([zero, scale, -scale * mean[1]]),
        stack([zero, zero, one]),
    ])


def homography_dlt(src, dst):
    """H (3, 3) mapping src (N, 2) → dst (N, 2), N ≥ 4: the normalized DLT
    (the smallest right singular vector of the 2N×9 design matrix),
    scaled to H[2, 2] = 1.  Tensors give a tensor of their dtype; the SVD
    is the device's, so f64 results agree with the host's to ~1e-12
    relative, not bit for bit."""
    if isinstance(src, torch.Tensor):
        xp, cat, linalg = torch, torch.cat, torch.linalg
    else:
        src, dst = np.asarray(src), np.asarray(dst)
        xp, cat, linalg = np, np.concatenate, np.linalg
    Ts = _normalization_transform(src)
    Td = _normalization_transform(dst)
    ones = xp.ones_like(src[..., :1])
    s_h = cat([src, ones], axis=-1) @ Ts.T
    d_h = cat([dst, ones], axis=-1) @ Td.T
    x, y = s_h[:, 0], s_h[:, 1]
    u, v = d_h[:, 0], d_h[:, 1]
    zero, one = xp.zeros_like(x), xp.ones_like(x)
    rows_u = xp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u],
                      axis=-1)
    rows_v = xp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v],
                      axis=-1)
    A = cat([rows_u, rows_v], axis=0)
    _, _, vt = linalg.svd(A, full_matrices=False)
    H = linalg.inv(Td) @ vt[-1].reshape(3, 3) @ Ts
    return H / H[2, 2]


def apply_homography(H, pts):
    """H applied to points (..., 2), with the perspective divide."""
    if isinstance(pts, torch.Tensor):
        ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1) @ H.T
    else:
        pts = np.asarray(pts)
        ph = np.concatenate([pts, np.ones_like(pts[..., :1])],
                            axis=-1) @ np.transpose(H)
    return ph[..., :2] / ph[..., 2:3]


def perspective_transform_4pt(src4, dst4):
    """The exact 4-point homography (``cv2.getPerspectiveTransform``): the
    8×8 linear system solved directly."""
    if isinstance(src4, torch.Tensor):
        xp, solve = torch, torch.linalg.solve
        cat = torch.cat
    else:
        src4, dst4 = np.asarray(src4), np.asarray(dst4)
        xp, solve = np, np.linalg.solve
        cat = np.concatenate
    rows = []
    for i in range(4):
        x, y = src4[i, 0], src4[i, 1]
        u, v = dst4[i, 0], dst4[i, 1]
        zero, one = xp.zeros_like(x), xp.ones_like(x)
        rows.append(xp.stack([x, y, one, zero, zero, zero, -u * x, -u * y]))
        rows.append(xp.stack([zero, zero, zero, x, y, one, -v * x, -v * y]))
    h8 = solve(xp.stack(rows), dst4.reshape(-1))
    return cat([h8, xp.ones_like(h8[:1])]).reshape(3, 3)
