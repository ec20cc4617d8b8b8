"""Geometric evaluation of extrinsic poses: metrics the optimizer never saw.

Counterpart of ``vbr_tpu/pipelines/extrinsics_eval.py``.  Two pose sets
are scored on independent geometry:

  (a) corner reprojection: the 48 inner saddle corners measured from the
      mean checkerboard image by sub-pixel refinement seeded from BOTH
      hypotheses' predictions; a corner counts only where the two seeds
      converge to one saddle, and the measurement is their mean;
  (b) cross-camera triangulation of each measured corner from every
      camera's undistorted ray, against the known 115 mm lattice (mm);
  (c) carve A/B: the hull of the silhouettes under each pose set, and the
      share of each silhouette the back-projected hull covers.

The refinement (``corners.corner_subpix``, both seed sets in one batch),
the table builds, the carve and the coverage scatter run on ``device``;
the rest is host f64 numpy copied from the JAX package.  The port's
projection tables equal the f64 host projection, so ``hull_coverage``
equals ``vbr_tpu``'s arithmetic on ``vbr_tpu``'s f64 tables.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.ops import corners as corner_ops
from vbr_tpu_torch.pipelines.auto_extrinsics import _PATTERN, _undist_px
from vbr_tpu_torch.utils.config import CameraParams, GridConfig
from vbr_tpu_torch.utils.device import resolve_device


def board_object_points(square_mm: float = 115.0, pattern=_PATTERN):
    """(N, 3) world-frame inner-corner lattice (the convention of the
    rig's config.xml poses and ``auto_extrinsics``)."""
    cols, rows = pattern
    return np.array(
        [[x * square_mm, y * square_mm, 0.0]
         for y in range(rows) for x in range(cols)],
        np.float64,
    )


def predicted_corners(cp: CameraParams, rvec, tvec,
                      square_mm: float = 115.0, pattern=_PATTERN):
    """Project the board lattice under (rvec, tvec) → (N, 2) pixels."""
    obj = board_object_points(square_mm, pattern)
    return cam_ops.project_points(
        obj, np.asarray(rvec).ravel(), np.asarray(tvec).ravel(),
        np.asarray(cp.K), np.asarray(cp.dist),
    )


def measure_saddle_corners(
    gray: np.ndarray,
    seeds_a: np.ndarray,
    seeds_b: np.ndarray,
    win: int = 3,
    seed_tol: float = 0.35,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Seed-independent saddle-corner measurement.

    Refines from both hypotheses' predicted corners on ``device``; a
    corner is *kept* iff both runs converge to the same saddle (< seed_tol
    px apart), stay inside the image and stay within 2.5·win of their
    seeds.  Returns (measured (N, 2), kept (N,) bool); measured rows of
    dropped corners are the seed mean (do not use them).
    """
    g = torch.from_numpy(np.ascontiguousarray(gray, np.float32)).to(
        resolve_device(device))
    n = len(seeds_a)
    both = np.concatenate([np.asarray(seeds_a, np.float32),
                           np.asarray(seeds_b, np.float32)])
    r = corner_ops.corner_subpix(g, both, (win, win)).cpu().numpy()
    ra, rb = r[:n], r[n:]
    d = np.linalg.norm(ra - rb, axis=1)
    H, W = np.asarray(gray).shape[:2]
    inside = (
        (ra[:, 0] > win) & (ra[:, 0] < W - win - 1)
        & (ra[:, 1] > win) & (ra[:, 1] < H - win - 1)
    )
    # reject refinements that ran away from both seeds (flat texture)
    near = (
        (np.linalg.norm(ra - seeds_a, axis=1) < 2.5 * win)
        & (np.linalg.norm(rb - seeds_b, axis=1) < 2.5 * win)
    )
    kept = (d < seed_tol) & inside & near
    return (ra + rb) / 2.0, kept


def reprojection_rms(predicted: np.ndarray, measured: np.ndarray,
                     kept: np.ndarray) -> float:
    """RMS px distance over kept corners."""
    if not kept.any():
        return float("nan")
    d = np.linalg.norm(predicted[kept] - measured[kept], axis=1)
    return float(np.sqrt(np.mean(d ** 2)))


def _camera_rays(measured: np.ndarray, cp: CameraParams, rvec, tvec):
    """Back-project measured pixels → (origin (3,), dirs (N, 3)) world."""
    K = np.asarray(cp.K)
    dist = np.asarray(cp.dist)
    und = _undist_px(measured, K, dist)  # ideal pixel coords
    xn = (und[:, 0] - K[0, 2]) / K[0, 0]
    yn = (und[:, 1] - K[1, 2]) / K[1, 1]
    d_cam = np.stack([xn, yn, np.ones_like(xn)], -1)
    R = cam_ops.rodrigues(np.asarray(rvec).ravel())
    origin = -R.T @ np.asarray(tvec, np.float64).ravel()
    dirs = d_cam @ R  # R.T applied row-wise
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origin, dirs


def triangulate_rays(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing Σ dist²(X, ray_i) (closed form)."""
    eye = np.eye(3)
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, d in zip(origins, dirs):
        P = eye - np.outer(d, d)
        A += P
        b += P @ o
    return np.linalg.solve(A, b)


@dataclasses.dataclass
class GeometricReport:
    """Per-pose-set geometric metrics (one report per hypothesis)."""

    reproj_rms_px: List[float]  # per camera
    kept_corners: List[int]  # per camera (seed-consistent saddles)
    triangulation_rms_mm: float
    triangulated_points: int


def evaluate_pose_sets(
    grays: Sequence[np.ndarray],
    cams: Sequence[CameraParams],
    poses_a: Sequence[Tuple[np.ndarray, np.ndarray]],
    poses_b: Sequence[Tuple[np.ndarray, np.ndarray]],
    square_mm: float = 115.0,
    pattern=_PATTERN,
    win: int = 3,
    device="cuda",
) -> Tuple[GeometricReport, GeometricReport]:
    """Score two pose hypotheses (A, B) on the same seed-independent
    corner measurements of each camera's gray image, refined on
    ``device``.  Returns (report_a, report_b)."""
    C = len(cams)
    obj = board_object_points(square_mm, pattern)
    measured, kept = [], []
    pred_a, pred_b = [], []
    for ci in range(C):
        pa = predicted_corners(cams[ci], *poses_a[ci], square_mm, pattern)
        pb = predicted_corners(cams[ci], *poses_b[ci], square_mm, pattern)
        m, k = measure_saddle_corners(grays[ci], pa, pb, win=win,
                                      device=device)
        measured.append(m)
        kept.append(k)
        pred_a.append(pa)
        pred_b.append(pb)

    def build(preds, poses) -> GeometricReport:
        rms = [reprojection_rms(preds[ci], measured[ci], kept[ci])
               for ci in range(C)]
        rays = [
            _camera_rays(measured[ci], cams[ci], *poses[ci])
            for ci in range(C)
        ]
        errs = []
        for n in range(len(obj)):
            use = [ci for ci in range(C) if kept[ci][n]]
            if len(use) < 2:
                continue
            X = triangulate_rays(
                np.stack([rays[ci][0] for ci in use]),
                np.stack([rays[ci][1][n] for ci in use]),
            )
            errs.append(np.linalg.norm(X - obj[n]))
        tri = float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")
        return GeometricReport(
            reproj_rms_px=rms,
            kept_corners=[int(k.sum()) for k in kept],
            triangulation_rms_mm=tri,
            triangulated_points=len(errs),
        )

    return build(pred_a, poses_a), build(pred_b, poses_b)


@dataclasses.dataclass
class CarveABReport:
    """Silhouette-consistency A/B of two pose sets."""

    coverage_a: List[float]  # per camera: |proj(hull_a) ∩ sil| / |sil|
    coverage_b: List[float]
    voxels_a: int
    voxels_b: int
    hull_iou_ab: float


def hull_coverage(
    masks: np.ndarray,  # (C, H, W) u8 silhouettes
    cset: Sequence[CameraParams],  # full candidate calibration (K+pose)
    grid: Optional[GridConfig] = None,
    device="cuda",
):
    """Carve the hull under a candidate calibration (default grid 64³) on
    ``device``; per camera the coverage ``|proj(hull) ∩ sil| / |sil|`` of
    its silhouette, from the pixels the hull's voxels project to.

    This metric is sensitive to the principal point: a cx error in one
    camera shifts its silhouette cone sideways, which a board-solved pose
    compensates only at the board's depth, so at the subject's depth the
    cones miss each other and coverage drops.

    Returns ``(occ (N,) bool numpy, coverages per camera)``.
    """
    from vbr_tpu_torch.ops import carve

    dev = resolve_device(device)
    grid = grid or GridConfig(nx=64, ny=64, nz=64)
    C = len(cset)
    H, W = masks.shape[1:3]
    m_dev = torch.from_numpy(np.ascontiguousarray(masks)).to(dev)
    imgs = torch.zeros((C, H, W, 3), dtype=torch.uint8, device=dev)
    tabs = carve.build_projection_tables(cset, grid, (H, W), device=dev)
    occ, _ = carve.carve_from_tables(
        m_dev, imgs, tabs.valid, tabs.lin_idx,
        views_threshold=C, color_camera=0,
    )
    sil = m_dev.reshape(C, -1) > 0
    n_sil = sil.sum(1)
    n_cov = []
    for ci in range(C):
        pix = torch.zeros(H * W, dtype=torch.bool, device=dev)
        pix[tabs.lin_idx[ci][occ & tabs.valid[ci]].long()] = True
        n_cov.append((pix & sil[ci]).sum())
    n_cov = torch.stack(n_cov).cpu().numpy()
    n_sil = n_sil.cpu().numpy()
    covs = [float(n_cov[ci] / max(n_sil[ci], 1)) for ci in range(C)]
    return occ.cpu().numpy(), covs


def carve_silhouette_ab(
    masks: np.ndarray,  # (C, H, W) u8 silhouettes
    cams: Sequence[CameraParams],
    poses_a: Sequence[Tuple[np.ndarray, np.ndarray]],
    poses_b: Sequence[Tuple[np.ndarray, np.ndarray]],
    grid: Optional[GridConfig] = None,
    device="cuda",
) -> CarveABReport:
    """Carve the hull under each pose set on ``device``; measure how much
    of every input silhouette the back-projected hull explains.
    Misaligned poses shrink the cone intersection, so coverage drops."""

    def cset_for(poses):
        return [
            dataclasses.replace(
                cams[ci],
                rvec_xyz=tuple(np.asarray(poses[ci][0], float).ravel()),
                tvec_xyz=tuple(np.asarray(poses[ci][1], float).ravel()),
            )
            for ci in range(len(cams))
        ]

    occ_a, cov_a = hull_coverage(masks, cset_for(poses_a), grid, device)
    occ_b, cov_b = hull_coverage(masks, cset_for(poses_b), grid, device)
    inter = (occ_a & occ_b).sum()
    union = (occ_a | occ_b).sum()
    return CarveABReport(
        coverage_a=cov_a,
        coverage_b=cov_b,
        voxels_a=int(occ_a.sum()),
        voxels_b=int(occ_b.sum()),
        hull_iou_ab=float(inter / max(union, 1)),
    )
