"""Fully automatic extrinsic calibration of the rig.

Counterpart of ``vbr_tpu/pipelines/auto_extrinsics.py``.  Per camera: the
board sheet is the largest region that changed against the median
background (``largest_change_region``, its 3×3 dilation on ``device``);
the black squares are blobs of an adaptive threshold sweep
(``detect_black_squares``); the printed pattern's quad, the orientation
and a homography on the blob centroids give the inner corners
(``pattern_quad``, ``orient_and_fit_homography``); ``solve_pnp`` gives a
pose, and ``photometric_refine`` aligns an analytic blurred-checker model
with every board pixel by Adam.  The board's 180° ambiguity is resolved
across cameras by carving a low-resolution hull of synchronized person
silhouettes for each flip combination (``resolve_rig_orientation``).

The host stages are copies of the JAX package's numpy code, bit-equal on
the same inputs; the blobs are labelled by ``scipy.ndimage.label``
(``_label_host``: 4-connected, numbered in raster order of each
component's first pixel, as ``vbr_tpu``'s two-pass labeller numbers them).
The photometric loss and its gradient are f64 tensors on ``device``
(autograd; on a CUDA device one loss-and-gradient evaluation is captured
in a CUDA graph and replayed); Adam runs on the host in f64 numpy, as in
``vbr_tpu``.  The vote builds the port's projection tables and carves on
``device``.

Frames come as arrays or iterables of (H, W, 3) u8 BGR frames, one per
camera, or, in ``vbr_tpu``'s forms, from a path: ``temporal_mean_gray``
and ``median_background`` read a video file, ``quick_person_masks`` and
``auto_extrinsics`` a rig directory (``cam{i}/checkerboard.avi``,
``background.avi``, ``video.avi``), all through ``utils/video.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.ops import carve, morphology
from vbr_tpu_torch.ops import corners as corner_ops
from vbr_tpu_torch.pipelines import calibration
from vbr_tpu_torch.utils.config import CameraParams, GridConfig
from vbr_tpu_torch.utils.device import resolve_device

# pattern geometry: 8x6 inner corners = 9x7 squares (data/checkerboard.xml)
_PATTERN = (8, 6)


# ---------------------------------------------------------------------------
# image acquisition / segmentation
# ---------------------------------------------------------------------------


def _is_path(x) -> bool:
    return isinstance(x, (str, os.PathLike))


def _rig_dirs(data_dir, cam_indices, count: int) -> List[str]:
    """The ``cam{c}/`` directories of a rig directory, for ``cam_indices``
    (default 1 .. ``count``), in that order."""
    idx = list(cam_indices or range(1, count + 1))
    if len(idx) != count:
        raise ValueError("cam_indices must match cameras")
    return [os.path.join(os.fspath(data_dir), f"cam{c}") for c in idx]


def _frames(source):
    """Frames of a video path, or ``source`` itself (an array or an
    iterable of frames)."""
    if _is_path(source):
        from vbr_tpu_torch.utils import video as vio

        return vio.frame_iterator(os.fspath(source))
    return source


def temporal_mean_gray(frames, max_frames: int = 64) -> np.ndarray:
    """Mean grayscale image (f64) over the first ``max_frames`` of
    ``frames`` (a video path, or an array or iterable of BGR frames; the
    board is static), summed frame by frame as ``vbr_tpu`` sums them."""
    acc = None
    n = 0
    for frame in _frames(frames):
        g = (0.114 * frame[..., 0] + 0.587 * frame[..., 1]
             + 0.299 * frame[..., 2])
        acc = g if acc is None else acc + g
        n += 1
        if n >= max_frames:
            break
    if acc is None:
        if _is_path(frames):
            raise IOError(f"no frames in {frames}")
        raise ValueError("no frames")
    return acc / n


def median_background(frames, samples: int = 12,
                      step: int = 10) -> np.ndarray:
    """Per-pixel median BGR background (f64) over every ``step``-th of
    ``frames`` (a video path, or an array or iterable of frames),
    ``samples`` of them: ``np.median``, which averages the two middle
    values of an even count."""
    picked = []
    for i, frame in enumerate(_frames(frames)):
        if i % step == 0:
            picked.append(frame)
        if len(picked) >= samples:
            break
    return np.median(np.stack(picked), axis=0).astype(np.float64)


def _label_host(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labels (int32) of a bool image, numbered 1.. in raster
    order of each component's first pixel, and their count."""
    labels, n = scipy.ndimage.label(mask)
    return labels.astype(np.int32), int(n)


def largest_change_region(background: np.ndarray, frame: np.ndarray,
                          threshold: float = 40.0,
                          device="cuda") -> Optional[np.ndarray]:
    """Bool mask of the largest connected region of ``frame`` that changed
    against ``background``, labelled at half resolution and dilated back
    (3×3, on ``device``)."""
    diff = np.abs(frame.astype(np.float64) - background).max(axis=-1)
    mask = diff > threshold
    if mask.sum() < 100:
        return None
    small = mask[::2, ::2]
    labels, n = _label_host(small)
    if n == 0:
        return None
    areas = np.bincount(labels.ravel())[1:]
    big = 1 + int(np.argmax(areas))
    winner = np.zeros_like(mask)
    winner[::2, ::2] = labels == big
    w = torch.from_numpy(winner.astype(np.uint8) * 255).to(
        resolve_device(device))
    d = morphology.dilate(w, (3, 3)).cpu().numpy()
    return (d > 0) & mask


def convex_fill(hull: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Scanline-fill a convex polygon (hull (N, 2) xy) into a bool image."""
    H, W = shape
    out = np.zeros((H, W), bool)
    ys = np.arange(H)
    pts = np.asarray(hull, np.float64)
    n = len(pts)
    xmin = np.full(H, np.inf)
    xmax = np.full(H, -np.inf)
    for i in range(n):
        p, q = pts[i], pts[(i + 1) % n]
        y0, y1 = sorted((p[1], q[1]))
        sel = (ys >= np.floor(y0)) & (ys <= np.ceil(y1))
        if abs(q[1] - p[1]) < 1e-9:
            xs_lo = np.full(H, min(p[0], q[0]))
            xs_hi = np.full(H, max(p[0], q[0]))
        else:
            t = np.clip((ys - p[1]) / (q[1] - p[1]), 0.0, 1.0)
            xs_lo = xs_hi = p[0] + t * (q[0] - p[0])
        xmin = np.where(sel, np.minimum(xmin, xs_lo), xmin)
        xmax = np.where(sel, np.maximum(xmax, xs_hi), xmax)
    for y in range(H):
        if xmax[y] >= xmin[y]:
            a = max(int(np.ceil(xmin[y])), 0)
            b = min(int(np.floor(xmax[y])), W - 1)
            if b >= a:
                out[y, a : b + 1] = True
    return out


# ---------------------------------------------------------------------------
# blob detection + orientation + homography
# ---------------------------------------------------------------------------


def detect_black_squares(gray: np.ndarray, sheet: np.ndarray):
    """Adaptive-threshold black-square blobs inside the sheet mask.

    Sweeps thresholds between the sheet's black/white levels and keeps the
    one producing the most single-square-sized components (low thresholds
    split bloom-merged chains).  Returns (centroids (M, 2), threshold).
    """
    vals = gray[sheet]
    p5, p75 = np.percentile(vals, 5), np.percentile(vals, 75)
    best = None
    for frac in (0.5, 0.4, 0.3, 0.22, 0.15, 0.1):
        t = p5 + frac * (p75 - p5)
        dark = sheet & (gray < t)
        labels, n = _label_host(dark)
        if n == 0:
            continue
        areas = np.bincount(labels.ravel())[1:]
        ok = areas[areas >= 3]
        if len(ok) == 0:
            continue
        med = np.median(ok)
        singles = [i + 1 for i, a in enumerate(areas) if 3 <= a <= 2.0 * med]
        if best is None or len(singles) > len(best[2]):
            best = (t, labels, singles)
    if best is None:
        return np.zeros((0, 2)), 0.0
    t, labels, singles = best
    w = np.maximum(t - gray, 0.0)
    cents = []
    for i in singles:
        msk = labels == i
        ww = w[msk]
        yy, xx = np.nonzero(msk)
        cents.append([(xx * ww).sum() / ww.sum(), (yy * ww).sum() / ww.sum()])
    return np.asarray(cents), t


def pattern_quad(gray: np.ndarray, sheet: np.ndarray) -> Optional[np.ndarray]:
    """4 printed-pattern corners: convex hull of dark pixels (the 9x7
    pattern has black squares at all four corners) -> max-area quad."""
    vals = gray[sheet]
    t = (np.percentile(vals, 5) + np.percentile(vals, 75)) / 2
    dark = sheet & (gray < t)
    ys, xs = np.nonzero(dark)
    if len(xs) < 50:
        return None
    pts = np.stack([xs, ys], -1).astype(np.float64)
    hull = corner_ops._convex_hull(pts)
    if len(hull) < 4:
        return None
    quads = corner_ops._quad_candidates(hull, top_k=1)
    if not quads:
        return None
    return corner_ops.sort_corners_clockwise(quads[0])


def _undist_px(pts, K, dist):
    """Distorted pixels -> ideal (distortion-free) pixel coordinates."""
    n = np.asarray(cam_ops.undistort_points(pts, K, dist, num_iters=20))
    return np.stack([K[0, 0] * n[:, 0] + K[0, 2],
                     K[1, 1] * n[:, 1] + K[1, 2]], -1)


def _dist_px(und, K, dist):
    """Ideal pixel coordinates -> distorted pixels."""
    xn = (und[:, 0] - K[0, 2]) / K[0, 0]
    yn = (und[:, 1] - K[1, 2]) / K[1, 1]
    xd, yd = cam_ops.distort_normalized(xn, yn, np.asarray(dist).reshape(-1))
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def _pattern_grids(pattern=_PATTERN):
    cols, rows = pattern
    inner = np.array([[x, y] for y in range(1, rows + 1)
                      for x in range(1, cols + 1)], np.float64)
    black = np.array([(i + 0.5, j + 0.5) for i in range(cols + 1)
                      for j in range(rows + 1) if (i + j) % 2 == 0])
    return inner, black


def orient_and_fit_homography(
    gray: np.ndarray,
    quad: np.ndarray,
    centroids: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    pattern=_PATTERN,
):
    """Resolve the correct-aspect orientation and fit H on blob centroids.

    Returns (H mapping pattern-square coords -> ideal pixels, image inner
    corners (N, 2) distorted pixels, n_matched).  The 180-degree partner
    is NOT resolved here (see `flip_pose_180` / `resolve_rig_orientation`).
    """
    cols, rows = pattern
    inner, black = _pattern_grids(pattern)
    ideal = np.array([[0, 0], [cols + 1, 0], [cols + 1, rows + 1],
                      [0, rows + 1]], np.float64)
    quad_u = _undist_px(quad, K, dist)

    # 4 cyclic assignments scored by checker phase: corner squares are
    # black, so the correct pair has (phase-0 mean) << (phase-1 mean)
    ii, jj = np.meshgrid(np.arange(cols + 1), np.arange(rows + 1),
                         indexing="ij")
    centers = np.stack([ii + 0.5, jj + 0.5], -1).reshape(-1, 2)
    phase = ((ii + jj) % 2).reshape(-1)
    best = None
    for r in range(4):
        Hq = cam_ops.perspective_transform_4pt(
            ideal, np.roll(quad_u, -r, axis=0))
        px = _dist_px(cam_ops.apply_homography(Hq, centers), K, dist)
        xi = np.clip(px[:, 0].round().astype(int), 0, gray.shape[1] - 1)
        yi = np.clip(px[:, 1].round().astype(int), 0, gray.shape[0] - 1)
        vals = gray[yi, xi].astype(np.float64)
        score = vals[phase == 0].mean() - vals[phase == 1].mean()
        if best is None or score < best[0]:
            best = (score, Hq)
    _, H = best

    # iterate: match centroids -> black-square centers, refit H undistorted;
    # the claim radii scale with the board's image pitch
    obs_u = _undist_px(centroids, K, dist)
    n_matched = 0
    for it in range(4):
        pred = cam_ops.apply_homography(H, black)
        p10 = cam_ops.apply_homography(H, black + np.array([1.0, 0.0]))
        pitch = float(np.median(np.linalg.norm(p10 - pred, axis=1)))
        d = np.linalg.norm(obs_u[:, None, :] - pred[None, :, :], axis=-1)
        mi = d.argmin(1)
        md = d.min(1)
        sel = md < (max(6.0, 0.25 * pitch) if it == 0
                    else max(3.0, 0.12 * pitch))
        n_matched = int(sel.sum())
        if n_matched >= 6:
            H = cam_ops.homography_dlt(black[mi[sel]], obs_u[sel])
    ipts = _dist_px(cam_ops.apply_homography(H, inner), K, dist)
    return H, ipts, n_matched


# ---------------------------------------------------------------------------
# photometric pose refinement (differentiable board alignment)
# ---------------------------------------------------------------------------


def _refine_loss(dirs: torch.Tensor, I_obs: torch.Tensor, square_mm: float,
                 nu: int, nv: int):
    """``vbr_tpu``'s photometric loss as a function of the 9 parameters
    [rvec, tvec, log σ, a, b] (f64 tensors on ``dirs``' device), one torch
    operation per JAX operation.  The rotation is its own Rodrigues form
    θ = |r| + 1e-12 with no branches (not ``camera.rodrigues``, whose
    small-angle and near-π branches give another value and gradient)."""
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device)
    # a tensor divisor: CUDA divides by a host scalar as a multiplication by
    # its reciprocal, which rounds otherwise than the reference's division
    sq = torch.tensor(square_mm, dtype=dirs.dtype, device=dirs.device)

    def sqw(x, sig):
        acc = 0.0
        for k in (1, 3, 5, 7, 9):
            ks = k * math.pi * sig
            acc = acc + (4 / (k * math.pi)) * torch.exp(
                -0.5 * (ks * ks)) * torch.sin(k * math.pi * x)
        return acc

    def rodr(rv):
        th = torch.linalg.norm(rv) + 1e-12
        k = rv / th
        zero = torch.zeros_like(th)
        Km = torch.stack([torch.stack([zero, -k[2], k[1]]),
                          torch.stack([k[2], zero, -k[0]]),
                          torch.stack([-k[1], k[0], zero])])
        return eye + torch.sin(th) * Km + (1 - torch.cos(th)) * (Km @ Km)

    def loss(params):
        rv, tv = params[:3], params[3:6]
        sig = torch.exp(params[6])
        a, b = params[7], params[8]
        R = rodr(rv)
        Rt_t = R.T @ tv
        rd = dirs @ R  # row i = Rᵀ dir_i
        # near-edge-on rays (rd_z ≈ 0) clamped: an unclamped division gives
        # inf/NaN u, v whose residual·w is NaN·0; clamped, such pixels land
        # far off the board, where the window w zeroes them
        rdz = rd[:, 2]
        eps = torch.full_like(rdz, 1e-6)
        rdz = torch.where(torch.abs(rdz) < 1e-6,
                          torch.where(rdz < 0, -eps, eps), rdz)
        lam = Rt_t[2] / rdz
        Xb = lam[:, None] * rd - Rt_t[None, :]
        u = Xb[:, 0] / sq + 1.0
        v = Xb[:, 1] / sq + 1.0
        prod = sqw(u, sig) * sqw(v, sig)
        dedge = torch.minimum(torch.minimum(u, nu - u),
                              torch.minimum(v, nv - v))
        blend = 0.5 * (1 + torch.special.erf(dedge / (math.sqrt(2.0) * sig)))
        pat = blend * prod + (1 - blend) * (-1.0)  # margin is white
        w = ((u > -0.6) & (u < nu + 0.6) & (v > -0.6)
             & (v < nv + 0.6)).to(dirs.dtype)
        r = (a + b * pat - I_obs) * w
        return torch.sum(r * r) / torch.clamp(torch.sum(w), min=1.0)

    return loss


def photometric_refine(
    gray: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    rvec: np.ndarray,
    tvec: np.ndarray,
    square_mm: float,
    pattern=_PATTERN,
    iters: int = 400,
    device="cuda",
    route: Optional[str] = None,
):
    """Refine a board pose against all board pixels.

    Model: a pixel's ray (undistorted once on the host, pose-independent)
    meets the board plane at pattern coords (u, v); the expected intensity
    is ``a + b * blur_sq(u) * blur_sq(v)``, the separable Gaussian-blurred
    checkerboard.  Pose (6), blur σ and the two levels are fitted by Adam
    (host f64, ``vbr_tpu``'s rates) on the loss and gradient evaluated in
    f64 on ``device``; each step copies the 9 parameters up and the loss
    and gradient down.  ``route``: "graph" (the evaluation captured in a
    CUDA graph and replayed; CUDA only, the same kernels as "eager") or
    "eager"; None takes "graph" on a CUDA device.

    Returns (rvec, tvec, the loss at the last step's start).
    """
    # imported here: photometric_calibration imports this module
    from vbr_tpu_torch.pipelines.photometric_calibration import _capture

    dev = resolve_device(device)
    route = route or ("graph" if dev.type == "cuda" else "eager")
    if route == "graph" and dev.type != "cuda":
        raise ValueError("route='graph' needs a CUDA device")
    cols, rows = pattern
    nu, nv = cols + 1, rows + 1  # squares
    rv0 = np.asarray(rvec, np.float64).ravel()
    tv0 = np.asarray(tvec, np.float64).ravel()
    K = np.asarray(K, np.float64)

    # ROI bbox from projecting the pattern + margin
    margin = 0.7
    corners_w = np.array(
        [[(u - 1) * square_mm, (v - 1) * square_mm, 0.0]
         for u, v in [(-margin, -margin), (nu + margin, -margin),
                      (nu + margin, nv + margin), (-margin, nv + margin)]]
    )
    proj = cam_ops.project_points(corners_w, rv0, tv0, K, dist)
    Hh, Ww = gray.shape
    x0, y0 = np.maximum(np.floor(proj.min(0)).astype(int) - 3, 0)
    x1 = min(int(np.ceil(proj[:, 0].max())) + 3, Ww)
    y1 = min(int(np.ceil(proj[:, 1].max())) + 3, Hh)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    pix = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
    nrm = np.asarray(cam_ops.undistort_points(pix, K, dist, num_iters=20))
    dirs_np = np.concatenate([nrm, np.ones((len(nrm), 1))], -1)
    I_np = gray[y0:y1, x0:x1].ravel().astype(np.float64)

    loss = _refine_loss(torch.from_numpy(dirs_np).to(dev),
                        torch.from_numpy(I_np).to(dev), float(square_mm),
                        nu, nv)
    p_buf = torch.zeros(9, dtype=torch.float64, device=dev,
                        requires_grad=True)
    out = torch.zeros(10, dtype=torch.float64, device=dev)  # [L, grad]

    def evaluate():
        L = loss(p_buf)
        (g,) = torch.autograd.grad(L, p_buf)
        with torch.no_grad():
            out[0].copy_(L)
            out[1:].copy_(g)

    p = np.concatenate([
        rv0, tv0, [np.log(0.15)], [I_np.mean()],
        [-(np.percentile(I_np, 85) - np.percentile(I_np, 10)) / 2],
    ])
    with torch.no_grad():
        p_buf.copy_(torch.from_numpy(p))
    if route == "graph":
        evaluate = _capture(evaluate, (out,))

    def value_and_grad(p):
        with torch.no_grad():
            p_buf.copy_(torch.from_numpy(p))
        evaluate()
        lg = out.cpu().numpy()
        return lg[0], lg[1:].copy()

    lr = np.array([2e-3] * 3 + [2.0] * 3 + [5e-3, 0.5, 0.5])
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    L = None
    for it in range(iters):
        L, g = value_and_grad(p)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (it + 1))
        vh = v / (1 - 0.999 ** (it + 1))
        p = p - lr * mh / (np.sqrt(vh) + 1e-8)
    if L is None:  # iters == 0: evaluate only
        L, _ = value_and_grad(p)
    return p[:3].copy(), p[3:6].copy(), float(L)


def photometric_mse(gray, K, dist, rvec, tvec, square_mm,
                    pattern=_PATTERN) -> float:
    """Photometric residual of a FIXED pose with nuisances re-fit (host
    f64): for each blur σ of a small sweep the levels (a, b) are solved in
    closed form; the best MSE is returned.  Lower = the pose explains the
    checkerboard image better."""
    cols, rows = pattern
    nu, nv = cols + 1, rows + 1
    rv0 = np.asarray(rvec, np.float64).ravel()
    tv0 = np.asarray(tvec, np.float64).ravel()
    K = np.asarray(K, np.float64)
    corners_w = np.array(
        [[(u - 1) * square_mm, (v - 1) * square_mm, 0.0]
         for u, v in [(-0.7, -0.7), (nu + 0.7, -0.7), (nu + 0.7, nv + 0.7),
                      (-0.7, nv + 0.7)]]
    )
    proj = cam_ops.project_points(corners_w, rv0, tv0, K, dist)
    Hh, Ww = gray.shape
    x0, y0 = np.maximum(np.floor(proj.min(0)).astype(int) - 3, 0)
    x1 = min(int(np.ceil(proj[:, 0].max())) + 3, Ww)
    y1 = min(int(np.ceil(proj[:, 1].max())) + 3, Hh)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    pix = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
    nrm = np.asarray(cam_ops.undistort_points(pix, K, dist, num_iters=20))
    dirs = np.concatenate([nrm, np.ones((len(nrm), 1))], -1)
    I = gray[y0:y1, x0:x1].ravel().astype(np.float64)

    R = np.asarray(cam_ops.rodrigues(rv0))
    Rt_t = R.T @ tv0
    rd = dirs @ R
    lam = Rt_t[2] / rd[:, 2]
    Xb = lam[:, None] * rd - Rt_t[None, :]
    u = Xb[:, 0] / square_mm + 1.0
    v = Xb[:, 1] / square_mm + 1.0
    roi = (u > -0.6) & (u < nu + 0.6) & (v > -0.6) & (v < nv + 0.6)
    if roi.sum() < 100:
        return float("inf")

    erf_v = np.vectorize(math.erf)
    best = None
    for sig in (0.04, 0.06, 0.08, 0.12, 0.2):

        def sqw_np(x):
            acc = 0.0
            for k in (1, 3, 5, 7, 9):
                acc = acc + (4 / (k * np.pi)) * np.exp(
                    -0.5 * (k * np.pi * sig) ** 2) * np.sin(k * np.pi * x)
            return acc

        prod = sqw_np(u) * sqw_np(v)
        dedge = np.minimum(np.minimum(u, nu - u), np.minimum(v, nv - v))
        blend = 0.5 * (1 + erf_v(dedge / (np.sqrt(2.0) * sig)))
        pat = blend * prod + (1 - blend) * (-1.0)
        A = np.stack([np.ones(roi.sum()), pat[roi]], -1)
        sol, *_ = np.linalg.lstsq(A, I[roi], rcond=None)
        r = A @ sol - I[roi]
        mse = float((r * r).mean())
        if best is None or mse < best:
            best = mse
    return best


def resolve_rig_orientation(
    cameras: Sequence[CameraParams],
    candidate_poses: Sequence[Tuple[np.ndarray, np.ndarray]],
    masks: np.ndarray,
    square_mm: float = 115.0,
    pattern=_PATTERN,
    grid: Optional[GridConfig] = None,
    device="cuda",
):
    """Resolve each camera's 180-degree board ambiguity by hull voting.

    ``candidate_poses[c] = (rvec, tvec)`` is orientation A for camera c;
    orientation B is the analytic 180-degree flip (`flip_pose_180`).
    Camera 0 anchors the world frame; the other cameras' orientations are
    chosen to maximize the hull-voxel count of the (C, H, W) u8 person
    ``masks`` carved on ``device`` at ``grid`` (default 32³): a flipped
    camera back-projects its silhouette across the room and the
    intersection collapses.  One table build and one carve per
    combination; the tables equal the f64 host projection.

    Returns (flips, votes): ``flips[c]`` bool per camera, ``votes`` the
    hull-voxel count per combination.
    """
    dev = resolve_device(device)
    grid = grid or GridConfig(nx=32, ny=32, nz=32)
    C = len(cameras)
    masks_d = torch.from_numpy(np.ascontiguousarray(masks)).to(dev)
    frames = torch.zeros(masks.shape + (3,), dtype=torch.uint8, device=dev)

    def cams_for(flipbits):
        out = []
        for c in range(C):
            rv, tv = candidate_poses[c]
            if flipbits[c]:
                rv, tv = flip_pose_180(rv, tv, square_mm, pattern)
            out.append(dataclasses.replace(
                cameras[c], rvec_xyz=tuple(np.asarray(rv).ravel()),
                tvec_xyz=tuple(np.asarray(tv).ravel()),
            ))
        return out

    votes: Dict[Tuple[bool, ...], int] = {}
    best = None
    for code in range(2 ** (C - 1)):
        flips = (False,) + tuple(bool((code >> i) & 1) for i in range(C - 1))
        tables = carve.build_projection_tables(cams_for(flips), grid,
                                               masks.shape[1:3], device=dev)
        occ, _ = carve.carve_from_tables(
            masks_d, frames, tables.valid, tables.lin_idx,
            views_threshold=C, color_camera=0,
        )
        n = int(occ.sum())
        votes[flips] = n
        if best is None or n > best[1]:
            best = (flips, n)
    return list(best[0]), votes


def flip_pose_180(rvec, tvec, square_mm: float = 115.0, pattern=_PATTERN):
    """The pose for the 180-degree-rotated board frame.

    World frames A and B are related by a rotation of pi about the
    board-normal axis through the pattern center c:
    ``X_A = Rz(pi) (X_B - c) + c``, so ``R_B = R_A Rz(pi)`` and
    ``t_B = t_A + R_A (I - Rz(pi)) c``.
    """
    cols, rows = pattern
    R_A = np.asarray(cam_ops.rodrigues(np.asarray(rvec, np.float64).ravel()))
    t_A = np.asarray(tvec, np.float64).ravel()
    c = np.array([(cols - 1) / 2 * square_mm, (rows - 1) / 2 * square_mm, 0.0])
    Rz = np.diag([-1.0, -1.0, 1.0])
    R_B = R_A @ Rz
    t_B = t_A + R_A @ ((np.eye(3) - Rz) @ c)
    rv_B = np.asarray(cam_ops.rodrigues_inverse(R_B)).ravel()
    return rv_B, t_B


# ---------------------------------------------------------------------------
# person silhouettes for voting (cheap, model-free)
# ---------------------------------------------------------------------------


def quick_person_masks(backgrounds, frames=None, threshold: float = 35.0,
                       device="cuda", *, num_cameras: Optional[int] = None,
                       frame_index: int = 0,
                       cam_indices=None) -> np.ndarray:
    """(C, H, W) u8 foreground masks of one synchronized (H, W, 3) u8
    frame per camera against that camera's background image (as
    :func:`median_background` gives it): the largest changed region,
    crude but synchronized, enough for orientation voting.

    ``vbr_tpu``'s form ``quick_person_masks(data_dir, num_cameras=4,
    frame_index=0, threshold=35.0, cam_indices=None)``: ``backgrounds`` is
    a rig directory, and ``num_cameras`` may stand second, in the place of
    ``frames``; per camera of ``cam_indices`` (default 1 ..
    ``num_cameras``) the median of ``background.avi`` and frame
    ``frame_index`` of ``video.avi``.  Any other second argument, or
    ``num_cameras`` given twice, raises ``TypeError``; so do the path
    form's keywords beside arrays."""
    if _is_path(backgrounds):
        backgrounds, frames = _person_inputs(
            backgrounds, frames, num_cameras, frame_index, cam_indices)
    elif num_cameras is not None or cam_indices is not None \
            or frame_index != 0:
        raise TypeError("num_cameras, frame_index and cam_indices belong to "
                        "the data_dir form")
    masks = []
    for bg, frame in zip(backgrounds, frames):
        region = largest_change_region(bg, np.asarray(frame), threshold,
                                       device=device)
        masks.append(
            (region.astype(np.uint8) * 255) if region is not None
            else np.zeros(bg.shape[:2], np.uint8)
        )
    return np.stack(masks)


def _person_inputs(data_dir, second, num_cameras, frame_index, cam_indices):
    """``quick_person_masks``' path form → its array form's (backgrounds,
    frames)."""
    from vbr_tpu_torch.utils import video as vio

    if second is not None:
        if not isinstance(second, int) or isinstance(second, bool):
            raise TypeError(f"quick_person_masks(data_dir, ...) takes "
                            f"num_cameras second, not "
                            f"{type(second).__name__}")
        if num_cameras is not None:
            raise TypeError("num_cameras given twice")
        num_cameras = second
    # as in vbr_tpu, cam_indices wins over num_cameras
    count = len(cam_indices) if cam_indices else \
        4 if num_cameras is None else num_cameras
    dirs = _rig_dirs(data_dir, cam_indices, count)
    backgrounds = [median_background(os.path.join(d, "background.avi"))
                   for d in dirs]
    frames = [vio.get_frame(os.path.join(d, "video.avi"), frame_index)
              for d in dirs]
    return backgrounds, frames


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutoExtrinsicsResult:
    cameras: List[CameraParams]  # with refined rvec/tvec
    flips: List[bool]
    n_blobs: List[int]
    n_matched: List[int]
    photometric_mse: List[float]
    votes: Dict[Tuple[bool, ...], int]


def _rig_inputs(data_dir, second, third, cameras, cam_indices,
                resolve_orientation):
    """``auto_extrinsics``' path form → its array form's (boards,
    backgrounds, person frames, cameras)."""
    from vbr_tpu_torch.utils import video as vio

    if cameras is None:
        cameras, second = second, None
    if second is not None or third is not None:
        raise TypeError("auto_extrinsics(data_dir, cameras, ...) reads the "
                        "frames from data_dir; pass no frames beside it")
    if cameras is None or not all(isinstance(c, CameraParams)
                                  for c in cameras):
        raise TypeError("auto_extrinsics(data_dir, cameras, ...) needs a "
                        "sequence of CameraParams second")
    dirs = _rig_dirs(data_dir, cam_indices, len(cameras))
    boards = [vio.frame_iterator(os.path.join(d, "checkerboard.avi"))
              for d in dirs]
    backs = [os.path.join(d, "background.avi") for d in dirs]
    person = ([vio.get_frame(os.path.join(d, "video.avi"), 0) for d in dirs]
              if resolve_orientation and len(cameras) >= 2 else None)
    return boards, backs, person, list(cameras)


def auto_extrinsics(
    checkerboard_frames,
    background_frames=None,
    person_frames=None,
    cameras: Optional[Sequence[CameraParams]] = None,
    square_mm: float = 115.0,
    pattern=_PATTERN,
    photometric_iters: int = 400,
    resolve_orientation: bool = True,
    device="cuda",
    cam_indices: Optional[Sequence[int]] = None,
) -> AutoExtrinsicsResult:
    """Fully automatic extrinsics of a rig (see the module docstring).

    Per camera, in the order of ``cameras`` (which provide K and dist;
    the poses are replaced): ``checkerboard_frames`` and
    ``background_frames`` are arrays or iterables of (H, W, 3) u8 BGR
    frames (the first 64 board frames are averaged; every 10th background
    frame, 12 of them, gives the median background); ``person_frames`` one
    synchronized (H, W, 3) u8 frame with the person in view, for the vote
    (unused without ``resolve_orientation`` or with one camera).

    ``vbr_tpu``'s form ``auto_extrinsics(data_dir, cameras, ...,
    cam_indices=None)``: the first argument is a rig directory and the
    cameras come second (or as ``cameras=``); camera i reads
    ``cam{cam_indices[i]}/`` (default 1 .. len(cameras)): its
    ``checkerboard.avi``, ``background.avi`` and frame 0 of ``video.avi``.
    Frames beside a path, or no cameras, raise ``TypeError``; so does
    ``cam_indices`` beside arrays.
    """
    if _is_path(checkerboard_frames):
        checkerboard_frames, background_frames, person_frames, cameras = \
            _rig_inputs(checkerboard_frames, background_frames,
                        person_frames, cameras, cam_indices,
                        resolve_orientation)
    elif cam_indices is not None:
        raise TypeError("cam_indices belongs to the data_dir form")
    dev = resolve_device(device)
    cand = []
    n_blobs, n_matched, mses, backgrounds = [], [], [], []
    for ci, cp in enumerate(cameras):
        board = list(itertools.islice(iter(checkerboard_frames[ci]), 64))
        gray = temporal_mean_gray(board)
        bg = median_background(background_frames[ci])
        backgrounds.append(bg)
        region = largest_change_region(bg, np.asarray(board[0]), device=dev)
        if region is None:
            raise RuntimeError(f"cam{ci + 1}: board region not found")
        hull = corner_ops._convex_hull(
            np.stack(np.nonzero(region)[::-1], -1).astype(np.float64)
        )
        sheet = convex_fill(hull, gray.shape)
        cents, _ = detect_black_squares(gray, sheet)
        quad = pattern_quad(gray, sheet)
        if quad is None or len(cents) < 6:
            raise RuntimeError(f"cam{ci + 1}: pattern not found "
                               f"({len(cents)} blobs)")
        K, dist = np.asarray(cp.K), np.asarray(cp.dist)
        _, ipts, nm = orient_and_fit_homography(gray, quad, cents, K, dist,
                                                pattern)
        cols, rows = pattern
        obj = np.array([[x * square_mm, y * square_mm, 0.0]
                        for y in range(rows) for x in range(cols)])
        rv, tv = calibration.solve_pnp(obj, ipts, K, dist, device=dev)
        rv = np.asarray(rv).ravel()
        tv = np.asarray(tv).ravel()
        if photometric_iters > 0:
            rv, tv, mse = photometric_refine(
                gray, K, dist, rv, tv, square_mm, pattern,
                iters=photometric_iters, device=dev,
            )
        else:
            mse = float("nan")
        cand.append((rv, tv))
        n_blobs.append(len(cents))
        n_matched.append(nm)
        mses.append(mse)

    if resolve_orientation and len(cameras) >= 2:
        masks = quick_person_masks(backgrounds, person_frames, device=dev)
        flips, votes = resolve_rig_orientation(
            cameras, cand, masks, square_mm, pattern, device=dev
        )
    else:
        flips, votes = [False] * len(cameras), {}

    out = []
    for cp, (rv, tv), fl in zip(cameras, cand, flips):
        if fl:
            rv, tv = flip_pose_180(rv, tv, square_mm, pattern)
        out.append(dataclasses.replace(
            cp, rvec_xyz=tuple(np.asarray(rv).ravel()),
            tvec_xyz=tuple(np.asarray(tv).ravel()),
        ))
    return AutoExtrinsicsResult(out, flips, n_blobs, n_matched, mses, votes)
