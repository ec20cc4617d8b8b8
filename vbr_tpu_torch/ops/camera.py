"""Pinhole camera math: float64 numpy on the host, and tensors.

Counterpart of ``vbr_tpu/ops/camera.py`` (``rodrigues``,
``rodrigues_inverse``, ``distort_normalized``, ``project_points_rt``,
``project_points``), with the same operation order, so the f64 projection
tables the carve reads are bit-identical to the JAX package's host build.

``rodrigues``, ``distort_normalized``, ``project_points_rt`` and
``project_points`` also take tensors (as ``vbr_tpu``'s take ``xp=jnp``):
the f32 projection of the device table builds, one eager elementwise
operation at a time (no matmul, so no TF32, and no fused multiply-add).
"""

from __future__ import annotations

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
