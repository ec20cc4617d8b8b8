"""Detector-free photometric intrinsic calibration from board frames.

Counterpart of ``vbr_tpu/pipelines/photometric_calibration.py``: K, the
5-term distortion and every board pose fitted jointly by Adam on raw
pixels (a blurred-checker board model rendered on a fixed board-space
sample grid, projected through the full forward camera model, held
against the observed gray by a Huber residual), after a blob-lattice view
collection and a corner-LM warm start.

The host stages are copies of the JAX package's numpy code
(``suppress_overlay``, ``adaptive_dark_blobs``, ``grow_black_lattice``,
``board_view_from_frame``, ``_zhang_poses``); the blobs are labelled by
``auto_extrinsics._label_host``, as ``vbr_tpu`` labels them.  The
per-(frame, sample) support of the loss is computed on the host in f64 from
the warm start, as in ``vbr_tpu``.

The fit runs on ``device`` (default ``"cuda"``; no fallback to the CPU),
f32, one step over every frame at once: the forward pass is batched over
frames (no ``vmap``), the rotation is applied elementwise (no matmul, so no
TF32), and the gradient is autograd's.  In JAX a 500-step chunk is one
``lax.scan`` program; in eager PyTorch each step is a few hundred
launches, so on a CUDA device one Adam step (forward, backward, update,
the loss written to the curve) is captured once in a ``torch.cuda.CUDAGraph``
over static parameter, moment, step and learning-rate buffers and
replayed; the graph runs the same kernels as the eager step (``route=
"eager"``, the CPU's route), so both give the same bits.

``BoardView`` and ``PhotoCalibResult`` hold numpy arrays with the same
fields as the JAX package's, so views and warm starts cross between the
packages.  Frames come as arrays or iterables of frames, or as a video
path, decoded frame by frame through ``utils/video.py``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.pipelines.auto_extrinsics import _label_host
from vbr_tpu_torch.utils.device import resolve_device

_PATTERN = (8, 6)  # inner corners (cols, rows) -> 9x7 squares
_SQW_TERMS = (1, 3, 5, 7, 9, 11, 13, 15, 17, 19)  # the square wave's terms
_WARMUP = 3  # steps run (and undone) before a CUDA graph capture


# ---------------------------------------------------------------------------
# overlay suppression
# ---------------------------------------------------------------------------

def suppress_overlay(frame_bgr: np.ndarray, sat_thresh: float = 110.0,
                     iters: int = 120) -> Tuple[np.ndarray, np.ndarray]:
    """Mask saturated drawn annotations and fill them harmonically in gray:
    (filled f32 gray, bool overlay mask).  Saturation (max − min over BGR),
    a 3×3 dilation, BT.601 luma, Jacobi iterations of a 3×3 box over the
    masked pixels."""
    f = frame_bgr.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    sat = (np.maximum(np.maximum(b, g), r)
           - np.minimum(np.minimum(b, g), r))  # max − min over B, G, R
    mask = sat > sat_thresh
    m = mask
    m = m | np.roll(m, 1, 0) | np.roll(m, -1, 0)
    m = m | np.roll(m, 1, 1) | np.roll(m, -1, 1)
    mask = m
    g = (0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2])
    filled = g.copy()
    ys, xs = np.nonzero(mask)
    if len(ys):
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        sub = filled[max(0, y0 - 2):y1 + 2, max(0, x0 - 2):x1 + 2]
        smask = mask[max(0, y0 - 2):y1 + 2, max(0, x0 - 2):x1 + 2]
        for _ in range(iters):
            avg = _box3(sub)
            sub[smask] = avg[smask]
    return filled, mask


def _box3(a: np.ndarray) -> np.ndarray:
    p = np.pad(a, 1, mode="edge")
    return (
        p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
        + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
        + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
    ) / 9.0


# ---------------------------------------------------------------------------
# black-square blob lattice (background-free, whole image)
# ---------------------------------------------------------------------------

def adaptive_dark_blobs(
    gray: np.ndarray,
    win: int = 63,
    bias: float = 14.0,
    area_range: Tuple[int, int] = (80, 6000),
) -> np.ndarray:
    """(n, 2) centroids of dark blobs under a local-mean threshold (the
    board's black squares against their white surround), filtered by area
    and by bounding-box shape and fill."""
    g = gray.astype(np.float64)
    mean = _box_mean(g, win)
    dark = g < (mean - bias)
    # 1-px 4-neighbour erosion separates squares that touch at corners
    er = (dark
          & np.roll(dark, 1, 0) & np.roll(dark, -1, 0)
          & np.roll(dark, 1, 1) & np.roll(dark, -1, 1))
    # labelled at half resolution, centroids at full resolution
    labels2, n = _label_host(er[::2, ::2])
    if n == 0:
        return np.zeros((0, 2))
    cents = []
    areas2 = np.bincount(labels2.ravel())[1:]
    lo, hi = area_range
    w = np.maximum(mean - g, 0.0)
    boxes = scipy.ndimage.find_objects(labels2)
    for i in range(1, n + 1):
        a4 = areas2[i - 1] * 4
        if not (lo * 0.5 <= a4 <= hi):  # erosion shrinks small squares
            continue
        ys2, xs2 = boxes[i - 1]
        y0, y1 = ys2.start * 2, (ys2.stop - 1) * 2 + 2
        x0, x1 = xs2.start * 2, (xs2.stop - 1) * 2 + 2
        bw, bh = x1 - x0, y1 - y0
        if bw > 3 * bh or bh > 3 * bw:
            continue
        if a4 < 0.35 * bw * bh:  # stringy, not a filled square
            continue
        sub = er[y0:y1, x0:x1]
        ww = w[y0:y1, x0:x1] * sub
        tot = ww.sum()
        if tot <= 0:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        cents.append([(xx * ww).sum() / tot, (yy * ww).sum() / tot])
    return np.asarray(cents) if cents else np.zeros((0, 2))


def _box_mean(a: np.ndarray, win: int) -> np.ndarray:
    r = win // 2
    p = np.pad(a, ((r + 1, r), (r + 1, r)), mode="edge")
    ii = p.cumsum(0).cumsum(1)
    H, W = a.shape
    s = (ii[win:, win:] - ii[:-win, win:] - ii[win:, :-win]
         + ii[:-win, :-win])
    return s[:H, :W] / float(win * win)


def _black_centers(pattern=_PATTERN) -> np.ndarray:
    cols, rows = pattern
    return np.array([(i + 0.5, j + 0.5) for i in range(cols + 1)
                     for j in range(rows + 1) if (i + j) % 2 == 0],
                    np.float64)


def grow_black_lattice(
    cents: np.ndarray,
    pattern=_PATTERN,
    min_matched: int = 20,
) -> Optional[Tuple[np.ndarray, int]]:
    """Fit H (pattern-square coordinates → pixels) on black-square
    centroids: grow the 45-degree centroid lattice homography-guided from
    density-ranked seeds and place the pattern's black-square diamond with
    the most support.  (H, n_matched) or None; the orientation is resolved
    up to the board's 180-degree symmetry."""
    N = len(cents)
    black = _black_centers(pattern)
    if N < min(10, len(black) // 2):
        return None
    d = np.linalg.norm(cents[:, None] - cents[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    d_sorted = np.sort(d, axis=1)
    pitch = float(np.median(d_sorted[:, min(3, N - 1)]))
    dens = (d < 1.6 * pitch).sum(1)
    order = np.argsort(-dens)

    best = None
    for seed in order[: min(8, N)]:
        nn = np.argsort(d[seed])[:8]
        vecs = [cents[j] - cents[seed] for j in nn
                if 0.6 * pitch < d[seed, j] < 1.6 * pitch]
        for a in range(len(vecs)):
            for b in range(a + 1, len(vecs)):
                va, vb = vecs[a], vecs[b]
                cosang = abs(va @ vb) / (np.linalg.norm(va)
                                         * np.linalg.norm(vb))
                if cosang > 0.5:
                    continue
                got = _grow_assign(cents, d, seed, va, vb, pitch)
                if got is None:
                    continue
                fit = _fit_diamond(cents, got, pattern)
                if fit is not None and (best is None or fit[1] > best[1]):
                    best = fit
        if best is not None and best[1] >= len(black) - 2:
            break
    if best is None or best[1] < min_matched:
        return None
    return best


def _grow_assign(cents, d, seed, v1, v2, pitch, tol_frac=0.3):
    """Greedy homography-guided growth; {candidate index: (p, q)}."""
    assigned = {seed: (0, 0)}
    used = {seed}
    B = np.stack([v1, v2], axis=1)
    Hm = None
    changed = True
    while changed:
        changed = False
        coords = np.array([assigned[i] for i in assigned], np.float64)
        pos = cents[list(assigned.keys())]
        if len(assigned) >= 6:
            Hm = cam_ops.homography_dlt(coords, pos)

        def predict(c):  # (n, 2) lattice coordinates → (n, 1, 2) pixels
            if Hm is not None:
                return cam_ops.apply_homography(Hm, c)[:, None]
            return (cents[seed] + c @ B.T)[:, None]

        taken = set(assigned.values())
        frontier = set()
        for (cx, cy) in assigned.values():
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                cc = (cx + dx, cy + dy)
                if cc not in taken:
                    frontier.add(cc)
        # every frontier node predicted at once (the fit is fixed within a
        # pass); the claims stay greedy, in the set's order
        frontier = list(frontier)
        dist_all = np.linalg.norm(
            cents[None] - predict(np.asarray(frontier, np.float64)), axis=-1)
        for cc, dists in zip(frontier, dist_all):
            dists[list(used)] = np.inf
            j = int(dists.argmin())
            if dists[j] < tol_frac * pitch:
                assigned[j] = cc
                used.add(j)
                changed = True
    return assigned if len(assigned) >= 8 else None


def _fit_diamond(cents, assigned, pattern):
    """Place the 9x7 black diamond over the grown lattice coordinates (the
    four orientations, every offset) and fit the final H; None when the
    fit is loose (an accidental lattice: floor mats and the like)."""
    cols, rows = pattern
    nu, nv = cols + 1, rows + 1
    idxs = list(assigned.keys())
    pq = np.array([assigned[i] for i in idxs], np.int64)
    best = None
    for swap in (False, True):
        for sgn in (1, -1):
            p = pq[:, 1] if swap else pq[:, 0]
            q = (pq[:, 0] if swap else pq[:, 1]) * sgn
            x = p + q
            y = p - q
            for ox in range(int(-x.min()) - 1, int(nu - x.max()) + 2):
                for oy in range(int(-y.min()) - 1, int(nv - y.max()) + 2):
                    bx = x + ox
                    by = y + oy
                    ok = ((bx >= 0) & (bx < nu) & (by >= 0) & (by < nv)
                          & ((bx + by) % 2 == 0))
                    support = int(ok.sum())
                    if best is None or support > best[0]:
                        best = (support, swap, sgn, ox, oy)
    if best is None:
        return None
    support, swap, sgn, ox, oy = best
    p = pq[:, 1] if swap else pq[:, 0]
    q = (pq[:, 0] if swap else pq[:, 1]) * sgn
    bx = p + q + ox
    by = p - q + oy
    ok = ((bx >= 0) & (bx < nu) & (by >= 0) & (by < nv)
          & ((bx + by) % 2 == 0))
    if ok.sum() < 8:
        return None
    src = np.stack([bx[ok] + 0.5, by[ok] + 0.5], -1).astype(np.float64)
    dst = cents[np.asarray(idxs)[ok]]
    H = cam_ops.homography_dlt(src, dst)
    pred = cam_ops.apply_homography(H, src)
    rms = float(np.sqrt(((pred - dst) ** 2).sum(-1).mean()))
    p10 = cam_ops.apply_homography(H, src + [1.0, 0.0])
    pitch_px = float(np.median(np.linalg.norm(p10 - pred, axis=1)))
    if rms > 0.12 * pitch_px:
        return None
    return H, int(ok.sum())


# ---------------------------------------------------------------------------
# view collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BoardView:
    frame_idx: int
    H: np.ndarray            # pattern-square coords -> raw pixels
    n_matched: int
    gray: np.ndarray         # de-overlayed float32 gray (full frame)
    wmask: np.ndarray        # float32 weights (0 = overlay/invalid)
    corners: np.ndarray      # H-predicted inner corners (cols*rows, 2)


def board_view_from_frame(
    frame_bgr: np.ndarray,
    frame_idx: int = 0,
    pattern=_PATTERN,
    min_matched: int = 20,
    deoverlay: bool = True,
) -> Optional[BoardView]:
    """The board in one (H, W, 3) u8 BGR frame, or None when no lattice
    fits (host numpy)."""
    cols, rows = pattern
    inner = np.array([[x, y] for y in range(1, rows + 1)
                      for x in range(1, cols + 1)], np.float64)
    if deoverlay:
        gray, om = suppress_overlay(frame_bgr)
        wmask = 1.0 - om.astype(np.float32)
    else:
        f = frame_bgr.astype(np.float32)
        gray = (0.114 * f[..., 0] + 0.587 * f[..., 1]
                + 0.299 * f[..., 2])
        wmask = np.ones(gray.shape, np.float32)
    cents = adaptive_dark_blobs(gray)
    got = grow_black_lattice(cents, pattern, min_matched=min_matched)
    if got is None:
        return None
    H, nm = got
    corners = cam_ops.apply_homography(H, inner)
    hh, ww = gray.shape
    if (corners < -20).any() or (corners[:, 0] > ww + 20).any() \
            or (corners[:, 1] > hh + 20).any():
        return None
    return BoardView(frame_idx, H, nm, gray.astype(np.float32),
                     wmask, corners)


def _frames_from(frames) -> Iterable[np.ndarray]:
    """The frames of a video path (decoded one by one), or ``frames``."""
    if isinstance(frames, (str, os.PathLike)):
        from vbr_tpu_torch.utils import video as vio

        return vio.frame_iterator(os.fspath(frames))
    return frames


def collect_board_views(
    frames: Iterable[np.ndarray],
    pattern=_PATTERN,
    frame_step: int = 1,
    max_views: int = 64,
    min_matched: int = 20,
    deoverlay: bool = True,
) -> List[BoardView]:
    """The board in every ``frame_step``-th frame of an iterable of
    (H, W, 3) u8 BGR frames (or of a video path), up to ``max_views``
    views."""
    views: List[BoardView] = []
    for fi, frame in enumerate(_frames_from(frames)):
        if fi % frame_step:
            continue
        v = board_view_from_frame(np.asarray(frame), fi, pattern,
                                  min_matched=min_matched,
                                  deoverlay=deoverlay)
        if v is None:
            continue
        views.append(v)
        if len(views) >= max_views:
            break
    return views


# ---------------------------------------------------------------------------
# joint photometric calibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhotoCalibResult:
    K: np.ndarray
    dist: np.ndarray
    rvecs: np.ndarray        # (F, 3)
    tvecs: np.ndarray        # (F, 3)
    mse: np.ndarray          # (F,) final per-frame photometric MSE
    frame_indices: np.ndarray
    loss_curve: np.ndarray


def _zhang_poses(views, image_shape, pattern, square_mm):
    from vbr_tpu_torch.pipelines import calibration as calib

    # H maps pattern-square coords; Zhang wants metric board plane -> px.
    # pattern coords (u,v) inner corners start at (1,1) <-> object (0,0)mm
    S = np.array([[square_mm, 0, -square_mm],
                  [0, square_mm, -square_mm],
                  [0, 0, 1.0]])
    Hs = [v.H @ np.linalg.inv(S) for v in views]
    K0 = calib.zhang_intrinsic_init(Hs, image_shape)
    poses = [calib.pose_from_homography(H, K0) for H in Hs]
    return K0, poses


class PhotometricProblem:
    """The photometric objective of a set of views on ``device``: the
    packed start ``p0`` and learning rates ``lr`` (host f32, as
    ``vbr_tpu`` packs them: [fx fy cx cy k1 k2 p1 p2 k3 | F·(rvec tvec) |
    F·(log_sigma a b gx gy)]), the board samples and frames on the
    device, :meth:`loss` and :meth:`run` (the staged Adam loop)."""

    def __init__(self, views, image_shape, pattern=_PATTERN,
                 square_mm=115.0, samples_per_square=12, huber_delta=18.0,
                 fix_tangential=False, fix_pp=None, init=None,
                 pixel_sigma=True, oob_penalty=None, device="cuda"):
        self.device = dev = resolve_device(device)
        cols, rows = pattern
        nu, nv = cols + 1, rows + 1
        F = len(views)
        if F < 3:
            raise ValueError(f"need >=3 views, got {F}")
        W, Hh = image_shape
        if init is None:
            K0, poses = _zhang_poses(views, image_shape, pattern, square_mm)
            dist0 = np.zeros(5)
        else:
            K0, dist0, poses = init

        # board-space sample grid (shared by all frames), in square units
        margin = 0.6
        su = np.linspace(-margin, nu + margin,
                         int((nu + 2 * margin) * samples_per_square))
        sv = np.linspace(-margin, nv + margin,
                         int((nv + 2 * margin) * samples_per_square))
        uu, vv = np.meshgrid(su, sv, indexing="ij")
        grid_uv = np.stack([uu.ravel(), vv.ravel()], -1)          # (S, 2)
        S = len(grid_uv)
        obj = np.concatenate(
            [(grid_uv - 1.0) * square_mm, np.zeros((S, 1))], -1)  # (S, 3)

        p0 = np.concatenate(
            [[K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]], dist0]
            + [np.concatenate([np.ravel(r), np.ravel(t)]) for r, t in poses]
            + [np.array([np.log(0.8 if pixel_sigma else 0.10),
                         float(v.gray.mean()),
                         -float(np.percentile(v.gray, 85)
                                - np.percentile(v.gray, 15)) / 2, 0.0, 0.0])
               for v in views]
        ).astype(np.float32)
        lr = np.concatenate(
            [[0.5, 0.5, 0.25, 0.25], [2e-3, 2e-3, 2e-4, 2e-4, 2e-3]]
            + [np.array([1e-3] * 3 + [1.0] * 3)] * F
            + [np.array([4e-3, 0.25, 0.25, 0.05, 0.05])] * F
        ).astype(np.float32)
        if fix_tangential:
            lr[6:8] = 0.0
        if fix_pp is not None:
            p0[2], p0[3] = float(fix_pp[0]), float(fix_pp[1])
            lr[2:4] = 0.0

        # The fixed per-(frame, sample) support: in bounds at the warm
        # start, host f64 as in vbr_tpu.  The loss normalizes by it and
        # charges a flat penalty for a support sample leaving the frame, so
        # the optimizer cannot shrink its own denominator.
        winb0 = np.zeros((F, S), np.float32)
        for i, (rv, tv) in enumerate(poses):
            uv = cam_ops.project_points(obj, np.ravel(rv), np.ravel(tv), K0,
                                        np.asarray(dist0, np.float64))
            winb0[i] = ((uv[:, 0] > 1.0) & (uv[:, 0] < W - 2.0)
                        & (uv[:, 1] > 1.0) & (uv[:, 1] < Hh - 2.0))
        self.oob_pen = (float(huber_delta * (2 * 100.0 - huber_delta))
                        if oob_penalty is None else float(oob_penalty))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.p0, self.lr = p0, lr
        self.F, self.S, self.nu, self.nv = F, S, nu, nv
        self.W, self.Hh = W, Hh
        self.square_mm, self.huber_delta = float(square_mm), huber_delta
        self.pixel_sigma = pixel_sigma
        self.ox, self.oy = f32(obj[:, 0]), f32(obj[:, 1])
        u_pat, v_pat = f32(grid_uv[:, 0]), f32(grid_uv[:, 1])
        self.dedge = torch.minimum(torch.minimum(u_pat, nu - u_pat),
                                   torch.minimum(v_pat, nv - v_pat))
        self.shade_u = u_pat / nu - 0.5
        self.shade_v = v_pat / nv - 0.5
        # the square wave's terms (4/kπ)·exp(−(kπσ)²/2)·sin(kπx): the
        # factors that do not depend on σ folded into one table per axis
        kpi = f32([k * math.pi for k in _SQW_TERMS])[:, None]
        coef = f32([4 / (k * math.pi) for k in _SQW_TERMS])[:, None]
        self.neg_half_kpi_sq = (-0.5 * (kpi * kpi))[:, :, None]
        # (terms, F, S), materialized: no broadcast in the step's products
        self.wave_u = (coef * torch.sin(kpi * u_pat))[:, None, :].expand(
            -1, F, -1).contiguous()
        self.wave_v = (coef * torch.sin(kpi * v_pat))[:, None, :].expand(
            -1, F, -1).contiguous()
        self.gray = f32(np.stack([v.gray for v in views])).reshape(-1)
        self.wmask = f32(np.stack([v.wmask for v in views])).reshape(-1)
        self.frame_base = (torch.arange(F, device=dev) * (Hh * W))[:, None]
        self.sup = f32(winb0)
        self.denom = torch.clamp(self.sup.sum(1), min=1.0)
        self.frame_indices = np.array([v.frame_idx for v in views])

    def masked_lr(self, groups: str) -> np.ndarray:
        """The learning rates of a stage that frees ``groups`` ("all", or
        a comma-separated list of intrinsics, dist, poses, nuisance)."""
        if groups == "all":
            return self.lr
        F = self.F
        mask = np.zeros_like(self.lr)
        for g in groups.split(","):
            g = g.strip()
            if g == "intrinsics":
                mask[0:4] = 1.0
            elif g == "dist":
                mask[4:9] = 1.0
            elif g == "poses":
                mask[9:9 + 6 * F] = 1.0
            elif g == "nuisance":
                mask[9 + 6 * F:] = 1.0
            else:
                raise ValueError(f"unknown stage group {g!r}")
        return self.lr * mask

    def loss(self, params: torch.Tensor, with_mse: bool = True):
        """(mean per-frame Huber loss, (F,) per-frame MSE or None) at
        ``params``."""
        F, W, Hh = self.F, self.W, self.Hh
        delta = self.huber_delta
        fx, fy, cx, cy, k1, k2, pt1, pt2, k3 = params[:9].unbind(0)
        pose = params[9:9 + 6 * F].reshape(F, 6)
        nuis = params[9 + 6 * F:].reshape(F, 5)
        R = _rodrigues_batched(pose[:, :3])
        t = pose[:, 3:6]
        # obj·Rᵀ + t elementwise; the samples lie on z = 0, so R's third
        # column adds exact zeros and is left out
        Xx, Xy, Xz = (R[:, i, 0, None] * self.ox + R[:, i, 1, None] * self.oy
                      + t[:, i, None] for i in range(3))
        z = torch.clamp(Xz, min=1.0)
        x = Xx / z
        y = Xy / z
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = x * rad + 2 * pt1 * x * y + pt2 * (r2 + 2 * x * x)
        yd = y * rad + pt1 * (r2 + 2 * y * y) + 2 * pt2 * x * y
        px = fx * xd + cx
        py = fy * yd + cy
        # bilinear sample of image and weight mask
        px0 = torch.clamp(px, 0.0, W - 1.001)
        py0 = torch.clamp(py, 0.0, Hh - 1.001)
        fx0 = torch.floor(px0)
        fy0 = torch.floor(py0)
        ax = px0 - fx0
        ay = py0 - fy0
        i00 = self.frame_base + fy0.long() * W + fx0.long()
        corners = torch.stack([i00, i00 + 1, i00 + W, i00 + W + 1])

        def bil(a):
            v00, v01, v10, v11 = torch.take(a, corners).unbind(0)
            return ((1 - ay) * ((1 - ax) * v00 + ax * v01)
                    + ay * ((1 - ax) * v10 + ax * v11))

        I_obs = bil(self.gray)
        w_obs = bil(self.wmask)
        inb = ((px > 1.0) & (px < W - 2.0) & (py > 1.0)
               & (py < Hh - 2.0)).to(torch.float32)
        if self.pixel_sigma:
            # blur sigma in pixels, converted to board units per sample
            # through the local projection scale (see vbr_tpu)
            pitch_px_sq = (torch.sqrt(fx * fy) * self.square_mm) / z
            drad = rad + 2 * r2 * (k1 + 2 * k2 * r2 + 3 * k3 * r2 * r2)
            pitch_px = pitch_px_sq * torch.sqrt(torch.abs(rad * drad) + 1e-6)
            sig_px = torch.exp(nuis[:, 0, None])
            sig = torch.clamp(sig_px / torch.clamp(pitch_px, min=1e-3),
                              1e-4, 0.45)
        else:
            sig = torch.exp(nuis[:, 0, None])
        a_lvl, b_lvl = nuis[:, 1, None], nuis[:, 2, None]
        shade = (1.0 + nuis[:, 3, None] * self.shade_u
                 + nuis[:, 4, None] * self.shade_v)
        # both square waves share each term's blur factor
        blur = torch.exp(self.neg_half_kpi_sq * (sig * sig))
        prod = (blur * self.wave_u).sum(0) * (blur * self.wave_v).sum(0)
        blend = 0.5 * (1 + torch.erf(self.dedge / (math.sqrt(2.0) * sig)))
        pat = blend * prod + (1 - blend) * (-1.0)
        r = (shade * (a_lvl + b_lvl * pat) - I_obs)
        w = w_obs * inb * self.sup
        absr = torch.abs(r)
        hub = torch.where(absr <= delta, r * r, delta * (2 * absr - delta))
        oob = self.oob_pen * (self.sup * (1.0 - inb)).sum(1)
        loss_f = ((hub * w).sum(1) + oob) / self.denom
        if not with_mse:
            return loss_f.mean(), None
        mse_f = (r * r * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        return loss_f.mean(), mse_f

    def value_and_grad(self, params=None):
        """(loss, gradient) at ``params`` (default ``p0``) as numpy."""
        p = torch.as_tensor(self.p0 if params is None else params,
                            device=self.device).clone().requires_grad_(True)
        L, _ = self.loss(p, with_mse=False)
        (g,) = torch.autograd.grad(L, p)
        return float(L.detach()), g.cpu().numpy()

    def run(self, stages, params=None, route=None):
        """Staged Adam from ``params`` (default ``p0``): for each (n,
        groups) of ``stages``, n steps with the other groups' rates zeroed
        and the moments reset.  ``route``: "graph" (one step captured in a
        CUDA graph and replayed; CUDA only) or "eager"; None takes
        "graph" on a CUDA device.  Returns (params tensor, loss curve
        numpy); ``ms_per_step`` then holds the steps' mean time (the
        capture left out)."""
        dev = self.device
        route = route or ("graph" if dev.type == "cuda" else "eager")
        if route == "graph" and dev.type != "cuda":
            raise ValueError("route='graph' needs a CUDA device")
        stages = [(int(n), g) for n, g in stages if n > 0]
        total = sum(n for n, _ in stages)
        p = torch.as_tensor(self.p0 if params is None else params,
                            device=dev).clone().requires_grad_(True)
        st = _AdamState(p, torch.zeros_like(p.detach()),
                        torch.zeros_like(p.detach()),
                        torch.zeros((), dtype=torch.float32, device=dev),
                        torch.zeros_like(p.detach()),
                        torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.zeros(total + _WARMUP, dtype=torch.float32,
                                    device=dev))

        def step():
            L, _ = self.loss(st.p, with_mse=False)
            (g,) = torch.autograd.grad(L, st.p)
            with torch.no_grad():
                st.m.mul_(0.9).add_(0.1 * g)
                st.v.mul_(0.999).add_(0.001 * g * g)
                st.t.add_(1.0)
                mh = st.m / (1 - 0.9 ** st.t)
                vh = st.v / (1 - 0.999 ** st.t)
                st.p.sub_(st.lr * mh / (torch.sqrt(vh) + 1e-8))
                st.curve.index_copy_(0, st.k, L.detach().reshape(1))
                st.k.add_(1)

        if route == "graph" and total:
            step = _capture(step, (st.p, st.m, st.v, st.t, st.lr, st.k,
                                   st.curve))
        clock = _Clock(dev)
        for n, groups in stages:
            with torch.no_grad():
                st.lr.copy_(torch.as_tensor(self.masked_lr(groups),
                                            device=dev))
                st.m.zero_()
                st.v.zero_()
                st.t.zero_()
            clock.start()
            for _ in range(n):
                step()
            clock.stop()
        self.ms_per_step = clock.ms() / max(total, 1)
        return st.p.detach(), st.curve[:total].cpu().numpy()

    def result(self, params: torch.Tensor, curve: np.ndarray):
        """The :class:`PhotoCalibResult` of fitted ``params``."""
        with torch.no_grad():
            _, mse = self.loss(params)
        p = params.cpu().numpy().astype(np.float64)
        F = self.F
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        pose = p[9:9 + 6 * F].reshape(F, 6)
        return PhotoCalibResult(
            K=K, dist=p[4:9].copy(), rvecs=pose[:, :3].copy(),
            tvecs=pose[:, 3:].copy(),
            mse=mse.cpu().numpy().astype(np.float64),
            frame_indices=self.frame_indices.copy(), loss_curve=curve)


class _Clock:
    """Milliseconds spent in the steps of a run: CUDA events on a card
    (what the device took, host waits included), the host clock on the
    CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.spans = []

    def start(self):
        self.t0 = (torch.cuda.Event(enable_timing=True) if self.cuda
                   else time.perf_counter())
        if self.cuda:
            self.t0.record()

    def stop(self):
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            self.spans.append((self.t0, t1))
        else:
            self.spans.append((time.perf_counter() - self.t0) * 1e3)

    def ms(self) -> float:
        if not self.cuda:
            return float(sum(self.spans))
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.spans))


@dataclasses.dataclass
class _AdamState:
    p: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    lr: torch.Tensor
    k: torch.Tensor      # steps taken: the next entry of ``curve``
    curve: torch.Tensor


def _capture(step, buffers: Sequence[torch.Tensor]):
    """``step`` captured in a CUDA graph: a few warm-up steps on a side
    stream (their effect on the tensors ``buffers`` that it writes
    undone), then the capture; returns the replay."""
    keep = [x.detach().clone() for x in buffers]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(_WARMUP):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    with torch.no_grad():
        for x, saved in zip(buffers, keep):
            x.copy_(saved)
    return graph.replay


def _rodrigues_batched(rv: torch.Tensor) -> torch.Tensor:
    """(F, 3) axis-angle → (F, 3, 3), as ``vbr_tpu``'s fit writes it: θ =
    |r| + 1e-12, R = I + sin θ K + (1 − cos θ) K², K² elementwise."""
    th = torch.sqrt((rv * rv).sum(1, keepdim=True)) + 1e-12
    k = rv / th
    zero = torch.zeros_like(k[:, 0])
    Km = torch.stack([
        torch.stack([zero, -k[:, 2], k[:, 1]], dim=-1),
        torch.stack([k[:, 2], zero, -k[:, 0]], dim=-1),
        torch.stack([-k[:, 1], k[:, 0], zero], dim=-1),
    ], dim=1)
    K2 = (Km[:, :, :, None] * Km[:, None, :, :]).sum(2)
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device)
    th = th[:, :, None]
    return eye + torch.sin(th) * Km + (1 - torch.cos(th)) * K2


def photometric_calibrate(
    views: Sequence[BoardView],
    image_shape: Tuple[int, int],
    pattern=_PATTERN,
    square_mm: float = 115.0,
    samples_per_square: int = 12,
    iters: int = 600,
    chunk: int = 100,
    huber_delta: float = 18.0,
    fix_tangential: bool = False,
    fix_pp: Optional[Tuple[float, float]] = None,
    init: Optional[Tuple[np.ndarray, np.ndarray, list]] = None,
    stages: Optional[Sequence[Tuple[int, str]]] = None,
    pixel_sigma: bool = True,
    oob_penalty: Optional[float] = None,
    device="cuda",
) -> PhotoCalibResult:
    """Jointly fit K, dist and every board pose photometrically on
    ``device``; ``image_shape`` is (width, height).  ``stages`` (default
    ``[(iters, "all")]``) releases the parameter groups in turn;
    ``fix_pp=(cx, cy)`` pins the principal point (start there, rates
    zeroed in every stage), the fit's weakest-determined direction.
    ``chunk`` is kept for the JAX package's signature: the loop has no
    chunks (on a card each step is one CUDA graph replay)."""
    del chunk
    prob = PhotometricProblem(
        views, image_shape, pattern, square_mm, samples_per_square,
        huber_delta, fix_tangential, fix_pp, init, pixel_sigma, oob_penalty,
        device)
    params, curve = prob.run(stages if stages is not None
                             else [(iters, "all")])
    return prob.result(params, curve)


# ---------------------------------------------------------------------------
# end-to-end entry point
# ---------------------------------------------------------------------------

def calibrate_video_photometric(
    frames: Iterable[np.ndarray],
    pattern=_PATTERN,
    square_mm: float = 115.0,
    frame_step: int = 1,
    max_views: int = 48,
    iters: int = 3000,
    chunk: int = 500,
    deoverlay: bool = True,
    samples_per_square: int = 12,
    device="cuda",
    fix_pp: Optional[Tuple[float, float]] = None,
) -> Tuple[PhotoCalibResult, List[BoardView]]:
    """Intrinsic calibration of one camera's board frames (an iterable of
    (H, W, 3) u8 BGR arrays, or a video path), detector-free: blob-lattice view collection
    (host), the corner LM on the H-predicted corners as warm start
    (``device``), then the photometric fit on ``device``, nuisances first
    (min(400, iters/6) steps), then everything."""
    from vbr_tpu_torch.pipelines import calibration as calib

    frames = _frames_from(frames)
    device = resolve_device(device)
    views = collect_board_views(
        frames, pattern=pattern, frame_step=frame_step,
        max_views=max_views, deoverlay=deoverlay)
    if len(views) < 3:
        raise ValueError(f"only {len(views)} usable board views")
    hh, ww = views[0].gray.shape
    init_res = calib.calibrate_camera(
        [v.corners.astype(np.float64) for v in views], (ww, hh),
        pattern, square_mm, device=device)
    poses = list(zip(init_res.rvecs, init_res.tvecs))
    n_nuis = min(400, iters // 6)
    res = photometric_calibrate(
        views, (ww, hh), pattern=pattern, square_mm=square_mm,
        iters=iters, chunk=chunk, samples_per_square=samples_per_square,
        init=(init_res.K, np.asarray(init_res.dist).reshape(-1)[:5].copy(),
              poses),
        stages=[(n_nuis, "nuisance"), (iters - n_nuis, "all")],
        device=device, fix_pp=fix_pp)
    return res, views
