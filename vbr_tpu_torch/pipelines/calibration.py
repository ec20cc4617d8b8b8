"""Camera calibration: Zhang intrinsics, Levenberg–Marquardt, PnP.

Counterpart of ``vbr_tpu/pipelines/calibration.py`` (in place of
``cv2.calibrateCameraExtended``, ``cv2.solvePnP`` / ``solvePnPRansac`` and
the reference's leave-one-out view discarding).  The closed-form start
(per-view normalized-DLT homographies, Zhang's absolute-conic intrinsics,
pose from each homography) is host f64 numpy, copied from the JAX package.
The refinement runs on ``device`` in f64: the residuals of every view are
one ``torch.func.vmap``, the Jacobian is ``torch.func.jacfwd`` of that, and
the damped normal equations are solved on the device.  Each trial step
reads its cost on the host (one sync), as ``vbr_tpu`` does.  A singular
damped system raises ``LinAlgError`` in torch where JAX returns non-finite
values; both end in ``lam *= 10``.

``CalibrationResult`` holds numpy arrays with the same fields as the JAX
package's, so a result of either package feeds the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.utils.device import resolve_device


def chessboard_object_points(
    chessboard_shape: Tuple[int, int], square_size: float
) -> np.ndarray:
    """(cols·rows, 3) planar grid, X fastest (the reference's ordering)."""
    cols, rows = chessboard_shape
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = np.zeros((cols * rows, 3), dtype=np.float64)
    pts[:, 0] = xs.reshape(-1) * square_size
    pts[:, 1] = ys.reshape(-1) * square_size
    return pts


def _homographies(obj_xy: np.ndarray, image_points: Sequence[np.ndarray]):
    return [cam_ops.homography_dlt(
        obj_xy, np.asarray(ip, dtype=np.float64).reshape(-1, 2))
        for ip in image_points]


def zhang_intrinsic_init(
    homographies: Sequence[np.ndarray], image_shape: Tuple[int, int]
) -> np.ndarray:
    """Closed-form K from ≥ 3 homographies through Zhang's absolute-conic
    B (V·b = 0 with v₁₂ᵀb = 0 and (v₁₁ − v₂₂)ᵀb = 0 per view); a centred
    single-focal guess when B is not positive definite."""

    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in homographies:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    V = np.asarray(V)
    _, _, vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = vt[-1]

    try:
        cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
        lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
        fx = np.sqrt(lam / b11)
        fy = np.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
        cx = -b13 * fx * fx / lam
        if not (np.isfinite([fx, fy, cx, cy]).all() and fx > 0 and fy > 0):
            raise FloatingPointError
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    except (FloatingPointError, ZeroDivisionError, ValueError):
        H, W = image_shape
        f = 1.2 * max(H, W)
        return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])


def pose_from_homography(H: np.ndarray, K: np.ndarray):
    """Planar pose: K⁻¹H = [λr₁ λr₂ λt] → (rvec, tvec), R projected onto
    SO(3), the board in front of the camera."""
    M = np.linalg.solve(K, H)
    lam = 1.0 / np.linalg.norm(M[:, 0])
    if M[2, 2] * lam < 0:
        lam = -lam
    r1 = M[:, 0] * lam
    r2 = M[:, 1] * lam
    t = M[:, 2] * lam
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1, 1, -1]) @ vt
    return cam_ops.rodrigues_inverse(R), t


@dataclasses.dataclass
class CalibrationResult:
    """``cv2.calibrateCameraExtended``'s outputs, as numpy arrays."""

    rms: float
    K: np.ndarray
    dist: np.ndarray  # (5,)
    rvecs: List[np.ndarray]
    tvecs: List[np.ndarray]
    per_view_errors: np.ndarray  # (V,) RMS px per view
    intrinsic_std: np.ndarray  # (9,) stddev of [fx fy cx cy k1 k2 p1 p2 k3]


def _pack(K, dist, rvecs, tvecs):
    return np.concatenate([
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
        np.asarray(dist).reshape(-1)[:5],
        np.concatenate([np.concatenate([r, t])
                        for r, t in zip(rvecs, tvecs)]),
    ])


def _intrinsic_matrix(p: torch.Tensor) -> torch.Tensor:
    zero, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
    return torch.stack([torch.stack([p[0], zero, p[2]]),
                        torch.stack([zero, p[1], p[3]]),
                        torch.stack([zero, zero, one])])


def _residual_fn(obj_pts, img_pts, num_views, device):
    """r(p) over all views, f64 on ``device``: [fx fy cx cy k1 k2 p1 p2 k3
    | (rvec, tvec) per view] → (V·N·2,) pixel residuals."""
    obj = torch.as_tensor(np.asarray(obj_pts, np.float64), device=device)
    imgs = torch.as_tensor(np.asarray(img_pts, np.float64), device=device)

    def per_view(pose, obs, K, dist):
        uv = cam_ops.project_points(obj, pose[:3], pose[3:], K, dist)
        return (uv - obs).reshape(-1)

    def residuals(p):
        K = _intrinsic_matrix(p)
        poses = p[9:].reshape(num_views, 6)
        return vmap(per_view, in_dims=(0, 0, None, None))(
            poses, imgs, K, p[4:9]).reshape(-1)

    return residuals


def _levenberg_marquardt(residuals_fn, p0, device, max_iters=50, tol=1e-12):
    """Dense LM, f64 on ``device``, Jacobians by ``torch.func.jacfwd``;
    returns (p, r, J) as numpy."""
    jac = jacfwd(residuals_fn)
    p = torch.as_tensor(np.asarray(p0, np.float64), device=device)
    lam = 1e-3
    r = residuals_fn(p)
    cost = float(r @ r)
    for _ in range(max_iters):
        J = jac(p)
        JtJ = J.T @ J
        g = J.T @ r
        improved = False
        for _ in range(10):
            A = JtJ + lam * torch.diag(torch.diag(JtJ))
            try:
                delta = torch.linalg.solve(A, -g)
            except torch.linalg.LinAlgError:
                lam *= 10
                continue
            p_new = p + delta
            r_new = residuals_fn(p_new)
            cost_new = float(r_new @ r_new)
            if np.isfinite(cost_new) and cost_new < cost:
                p, r = p_new, r_new
                rel = (cost - cost_new) / max(cost, 1e-30)
                cost = cost_new
                lam = max(lam * 0.3, 1e-12)
                improved = True
                break
            lam *= 10
        if not improved or rel < tol:
            break
    J = jac(p)
    return p.cpu().numpy(), r.cpu().numpy(), J.cpu().numpy()


def calibrate_camera(
    image_points: Sequence[np.ndarray],
    image_shape: Tuple[int, int],
    chessboard_shape: Tuple[int, int] = (8, 6),
    square_size: float = 1.0,
    device="cuda",
) -> CalibrationResult:
    """Intrinsic calibration (``cv2.calibrateCameraExtended``) from per-view
    (N, 2) corners in the reference's ordering; ``image_shape`` is (width,
    height).  The start is host f64; the LM runs on ``device``."""
    dev = resolve_device(device)
    obj = chessboard_object_points(chessboard_shape, square_size)
    num_views = len(image_points)
    img_pts = np.stack([np.asarray(ip, dtype=np.float64).reshape(-1, 2)
                        for ip in image_points])

    Hs = _homographies(obj[:, :2], image_points)
    K0 = zhang_intrinsic_init(Hs, image_shape)
    rvecs0, tvecs0 = [], []
    for H in Hs:
        r, t = pose_from_homography(H, K0)
        rvecs0.append(np.asarray(r))
        tvecs0.append(np.asarray(t))

    p0 = _pack(K0, np.zeros(5), rvecs0, tvecs0)
    res_fn = _residual_fn(obj, img_pts, num_views, dev)
    p, r, J = _levenberg_marquardt(res_fn, p0, dev)

    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    dist = p[4:9]
    poses = p[9:].reshape(num_views, 6)
    n = obj.shape[0]
    r_views = r.reshape(num_views, n, 2)
    per_view = np.sqrt((r_views**2).sum(-1).mean(-1))
    rms = float(np.sqrt((r**2).mean()) * np.sqrt(2))  # per-point L2 RMS

    # stddevs from the pseudo-inverse of JᵀJ (cv2's Extended outputs)
    dof = max(r.size - p.size, 1)
    sigma2 = float(r @ r) / dof
    try:
        cov = sigma2 * np.linalg.pinv(J.T @ J)
        std = np.sqrt(np.clip(np.diag(cov)[:9], 0, None))
    except np.linalg.LinAlgError:
        std = np.full(9, np.nan)

    return CalibrationResult(
        rms=rms, K=K, dist=dist,
        rvecs=[poses[i, :3] for i in range(num_views)],
        tvecs=[poses[i, 3:] for i in range(num_views)],
        per_view_errors=per_view, intrinsic_std=std,
    )


def solve_pnp(object_points: np.ndarray, image_points: np.ndarray,
              K: np.ndarray, dist: np.ndarray,
              device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Planar-target pose (``cv2.solvePnP`` for the chessboard): host f64
    undistortion and plane homography, then the 6-dof LM on ``device``
    (intrinsics fixed)."""
    dev = resolve_device(device)
    obj = np.asarray(object_points, dtype=np.float64).reshape(-1, 3)
    img = np.asarray(image_points, dtype=np.float64).reshape(-1, 2)
    und = cam_ops.undistort_points(img, K, np.asarray(dist).reshape(-1),
                                   num_iters=20)
    H = cam_ops.homography_dlt(obj[:, :2], und)
    r0, t0 = pose_from_homography(H, np.eye(3))

    obj_t = torch.as_tensor(obj, device=dev)
    img_t = torch.as_tensor(img, device=dev)
    K_t = torch.as_tensor(np.asarray(K, dtype=np.float64), device=dev)
    dist_t = torch.as_tensor(
        np.asarray(dist, dtype=np.float64).reshape(-1)[:5], device=dev)

    def residuals(p):
        uv = cam_ops.project_points(obj_t, p[:3], p[3:], K_t, dist_t)
        return (uv - img_t).reshape(-1)

    p0 = np.concatenate([np.asarray(r0), np.asarray(t0)])
    p, _, _ = _levenberg_marquardt(residuals, p0, dev, max_iters=50)
    return p[:3], p[3:]


def solve_pnp_ransac(
    object_points: np.ndarray,
    image_points: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    iterations: int = 100,
    reproj_threshold: float = 8.0,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RANSAC PnP: minimal 4-point homography hypotheses (the draws of
    ``np.random.default_rng(seed)``, as ``vbr_tpu``), all scored at once on
    ``device`` by their reprojection inliers; the first hypothesis with the
    most inliers wins, and ``solve_pnp`` refines on its inliers.  Returns
    (rvec, tvec, inlier_mask)."""
    dev = resolve_device(device)
    obj = np.asarray(object_points, dtype=np.float64).reshape(-1, 3)
    img = np.asarray(image_points, dtype=np.float64).reshape(-1, 2)
    dist = np.asarray(dist, dtype=np.float64).reshape(-1)
    n = obj.shape[0]
    rng = np.random.default_rng(seed)
    und = cam_ops.undistort_points(img, K, dist, num_iters=20)

    poses = []
    for _ in range(iterations):
        idx = rng.choice(n, 4, replace=False)
        try:
            H = cam_ops.perspective_transform_4pt(obj[idx, :2], und[idx])
            poses.append(np.concatenate(pose_from_homography(H, np.eye(3))))
        except np.linalg.LinAlgError:
            continue
    best_inliers = np.zeros(n, bool)
    if poses:
        obj_t = torch.as_tensor(obj, device=dev)
        K_t = torch.as_tensor(np.asarray(K, dtype=np.float64), device=dev)
        dist_t = torch.as_tensor(dist, device=dev)
        hyp = torch.as_tensor(np.stack(poses), device=dev)
        uv = vmap(lambda p: cam_ops.project_points(obj_t, p[:3], p[3:], K_t,
                                                   dist_t))(hyp)
        err = torch.linalg.norm(uv - torch.as_tensor(img, device=dev), dim=-1)
        inliers = (err < reproj_threshold).cpu().numpy()
        counts = inliers.sum(axis=1)
        if counts.max() > 0:
            best_inliers = inliers[int(np.argmax(counts))]
    if best_inliers.sum() < 4:
        best_inliers = np.ones(n, bool)
    rvec, tvec = solve_pnp(obj[best_inliers], img[best_inliers], K, dist,
                           device=dev)
    return rvec, tvec, best_inliers


def discard_bad_image_points(
    image_points: Sequence[np.ndarray],
    image_shape: Tuple[int, int],
    chessboard_shape: Tuple[int, int],
    square_size: float = 1.0,
    discard_threshold: float = 0.15,
    device="cuda",
):
    """Leave-one-out view discarding: recalibrate without each view and
    discard it where the RMS improves by at least ``discard_threshold``.
    Returns (kept_points, kept_idx, discarded_points, discarded_idx)."""
    baseline = calibrate_camera(image_points, image_shape, chessboard_shape,
                                square_size, device).rms
    kept, kept_idx, discarded, discarded_idx = [], [], [], []
    for i in range(len(image_points)):
        subset = [p for j, p in enumerate(image_points) if j != i]
        rms = calibrate_camera(subset, image_shape, chessboard_shape,
                               square_size, device).rms
        if baseline - rms >= discard_threshold:
            discarded.append(image_points[i])
            discarded_idx.append(i)
        else:
            kept.append(image_points[i])
            kept_idx.append(i)
    return kept, kept_idx, discarded, discarded_idx
