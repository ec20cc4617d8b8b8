"""Chessboard corner detection and sub-pixel refinement.

Counterpart of ``vbr_tpu/ops/corners.py``.  On the device, on the tensor's
own device (a numpy image goes to ``device``): the saddle-point response
(``saddle_response``), non-max suppression and the top-k candidates
(``top_corner_candidates``) and ``cv2.cornerSubPix``'s gradient-
orthogonality refinement (``corner_subpix``), every corner batched.  On the
host, as copies of the JAX package's numpy code: the X-junction filter,
the dominant cluster, the homography-guided lattice growth and the
canonical ordering, and the manual-corner helpers
(``sort_corners_clockwise``, ``interpolate_image_points_from_corners``,
``extract_board_quad``).

Two places where the device could order things otherwise than
``vbr_tpu``: ``jax.lax.top_k`` puts the lower flat index first among equal
scores, which ``torch.topk`` does not promise, so the candidates come from
a stable sort on (−score, index); and each corner of ``corner_subpix``
leaves its own ``while_loop`` after the update whose squared move falls
under eps² (that update applied) or at ``max_iters``, which the batched
loop keeps by freezing each corner at exactly that point.  The window sums
reduce in another order than XLA's, so refined corners agree to ~1e-4 px,
not bit for bit.
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.ops import color as color_ops
from vbr_tpu_torch.utils.device import resolve_device


def as_image(img, device) -> torch.Tensor:
    """A tensor stays on its device; a numpy image goes to ``device``."""
    if isinstance(img, torch.Tensor):
        return img
    return torch.from_numpy(np.ascontiguousarray(img)).to(
        resolve_device(device))


# ---------------------------------------------------------------------------
# cornerSubPix
# ---------------------------------------------------------------------------


def _bilinear_patches(img: torch.Tensor, q: torch.Tensor, half: int):
    """(N, 2·half+3, 2·half+3) patches sampled bilinearly around each
    centre ``q`` (N, 2) (x, y): one ring more than the window, for the
    gradients."""
    size = 2 * half + 3
    offs = torch.arange(size, dtype=torch.float32, device=img.device) - (
        half + 1)
    gx, gy = torch.meshgrid(offs, offs, indexing="xy")
    xs = q[:, 0, None, None] + gx
    ys = q[:, 1, None, None] + gy
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    H, W = img.shape
    x0i = torch.clamp(x0.to(torch.int32), 0, W - 2).long()
    y0i = torch.clamp(y0.to(torch.int32), 0, H - 2).long()
    i00 = img[y0i, x0i]
    i01 = img[y0i, x0i + 1]
    i10 = img[y0i + 1, x0i]
    i11 = img[y0i + 1, x0i + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def corner_subpix(image, corners, win: Tuple[int, int] = (11, 11),
                  max_iters: int = 30, eps: float = 0.1,
                  return_iters: bool = False, device="cuda"):
    """Sub-pixel corner refinement (``cv2.cornerSubPix`` semantics) of
    (N, 2) corners (x, y) on an (H, W) u8 or f32 gray image: q ←
    (Σ w ∇I∇Iᵀ)⁻¹ (Σ w ∇I∇Iᵀ p) over the (2·win+1)² window with OpenCV's
    separable weight mask, until the squared update falls under eps² (that
    update applied) or ``max_iters``.  Returns (N, 2) f32 on the image's
    device; with ``return_iters`` also each corner's (N,) iteration count.
    The host reads one flag per iteration, to stop once every corner has."""
    img = as_image(image, device).to(torch.float32)
    dev = img.device
    q = torch.as_tensor(corners).to(device=dev, dtype=torch.float32)
    half = win[0]
    size = 2 * half + 1
    c = torch.arange(size, dtype=torch.float32, device=dev) - half
    wx = torch.exp(-((c / half) ** 2))
    mask = wx[None, :] * wx[:, None]
    ogx, ogy = torch.meshgrid(c, c, indexing="xy")
    n = q.shape[0]
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    eps_sq = eps * eps
    for _ in range(max_iters):
        if n == 0 or not bool(active.any()):
            break
        patch = _bilinear_patches(img, q, half)
        gx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
        gy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5
        gxx = (gx * gx * mask).sum(dim=(1, 2))
        gxy = (gx * gy * mask).sum(dim=(1, 2))
        gyy = (gy * gy * mask).sum(dim=(1, 2))
        bx = ((gx * gx * ogx + gx * gy * ogy) * mask).sum(dim=(1, 2))
        by = ((gx * gy * ogx + gy * gy * ogy) * mask).sum(dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        safe = torch.abs(det) > 1e-12
        inv_det = torch.where(
            safe, 1.0 / torch.where(safe, det, torch.ones_like(det)),
            torch.zeros_like(det))
        dx = (gyy * bx - gxy * by) * inv_det
        dy = (gxx * by - gxy * bx) * inv_det
        q = torch.where(active[:, None], q + torch.stack([dx, dy], dim=-1), q)
        iters = iters + active.to(torch.int32)
        active = active & ((dx * dx + dy * dy) >= eps_sq)
    return (q, iters) if return_iters else q


# ---------------------------------------------------------------------------
# Chessboard detection
# ---------------------------------------------------------------------------


def _edge_rows(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """``x`` padded by ``r`` along ``dim`` with its edge values."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    return x.index_select(dim, idx)


def saddle_response(gray, device="cuda") -> torch.Tensor:
    """Chessboard-corner (saddle point) response: the negative Hessian
    determinant of the image under a 5×5 binomial blur, clipped at 0, on
    the image's device (f32, one operation at a time, the taps summed in
    ``vbr_tpu``'s order)."""
    img = as_image(gray, device).to(torch.float32)
    k = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    H, W = img.shape
    xpad = _edge_rows(img, 2, 0)
    x = sum(k[i] * xpad[i:i + H] for i in range(5))
    xpad = _edge_rows(x, 2, 1)
    s = sum(k[i] * xpad[:, i:i + W] for i in range(5))
    dxx = s[1:-1, 2:] - 2 * s[1:-1, 1:-1] + s[1:-1, :-2]
    dyy = s[2:, 1:-1] - 2 * s[1:-1, 1:-1] + s[:-2, 1:-1]
    dxy = (s[2:, 2:] - s[2:, :-2] - s[:-2, 2:] + s[:-2, :-2]) * 0.25
    det = dxx * dyy - dxy * dxy
    resp = torch.clamp(-det, min=0.0)
    return F.pad(resp, (1, 1, 1, 1))


def _window_max(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """The maximum over the 2r+1 values around each along ``dim``, −inf
    beyond the border."""
    n = x.shape[dim]
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim):2 * (1 - dim) + 2] = [r, r]
    xp = F.pad(x, pad, value=float("-inf"))
    out = xp.narrow(dim, 0, n)
    for i in range(1, 2 * r + 1):
        out = torch.maximum(out, xp.narrow(dim, i, n))
    return out


def top_corner_candidates(response: torch.Tensor, max_corners: int = 256,
                          nms_radius: int = 3):
    """Non-max suppression ((2r+1)² window, −inf beyond the border, a
    plateau keeps all its pixels) and the ``max_corners`` best: ((k, 2) xy
    f32, (k,) score) on the response's device, equal scores in ascending
    flat index, as ``jax.lax.top_k`` orders them (the zero scores of
    non-peaks included).  The host reads the number of peaks."""
    H, W = response.shape
    r = nms_radius
    # the (2r+1)² maximum as a row pass then a column pass of shifted
    # maxima (the same values as one max_pool2d, and quicker on the CPU)
    local_max = _window_max(_window_max(response, r, 1), r, 0)
    is_peak = ((response >= local_max) & (response > 0)).reshape(-1)
    # only the peaks are sorted; the zeros behind them come in index order
    peaks = torch.nonzero(is_peak).reshape(-1)
    score, order = torch.sort(response.reshape(-1)[peaks], descending=True,
                              stable=True)
    idx = peaks[order][:max_corners]
    if idx.numel() < max_corners:
        rest = torch.nonzero(~is_peak).reshape(-1)[:max_corners - idx.numel()]
        idx = torch.cat([idx, rest])
    score = torch.where(is_peak[idx], response.reshape(-1)[idx],
                        torch.zeros((), dtype=response.dtype,
                                    device=response.device))
    ys = (idx // W).to(torch.float32)
    xs = (idx % W).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), score


def detect_chessboard(gray, pattern_size: Tuple[int, int] = (8, 6),
                      score_rel_threshold: float = 0.02,
                      fit_tolerance: float = 5.0,
                      device="cuda") -> Optional[np.ndarray]:
    """Detect a (cols, rows) inner-corner chessboard in an (H, W) u8 gray
    image: (cols·rows, 2) f32 corners in canonical row-major order, or
    None.  Saddle response, candidates and both sub-pixel refinements run
    on the image's device (a numpy image goes to ``device``); the
    X-junction filter, the dominant cluster, the de-duplication and the
    lattice growth run on the host, as in ``vbr_tpu``."""
    img = as_image(gray, device)
    gray_host = (img.cpu().numpy() if isinstance(gray, torch.Tensor)
                 else np.asarray(gray))
    cols, rows = pattern_size
    n = cols * rows
    resp = saddle_response(img)
    cand, score = top_corner_candidates(resp, max_corners=max(12 * n, 512))
    cand = cand.cpu().numpy()
    score = score.cpu().numpy()
    keep = score > score_rel_threshold * score[0]
    cand = cand[keep]
    if len(cand) < n:
        return None
    cand = cand[_xjunction_score(gray_host, cand)]
    if len(cand) < n:
        return None
    cluster = _dominant_cluster(cand, min_size=n)
    if cluster is not None:
        cand = cluster
    cand = corner_subpix(img, cand, (5, 5)).cpu().numpy()
    cand = _dedupe(cand, radius=2.0)
    best = _grow_lattice(cand, pattern_size)
    if best is None:
        return None
    best = corner_subpix(img, best, (11, 11)).cpu().numpy()
    return _canonical_order(best, pattern_size)


def _grow_lattice(cand: np.ndarray, pattern_size, tol_frac: float = 0.35):
    """Homography-guided lattice growth over corner candidates: seeds a
    unit cell at the most central candidates, then alternates a lattice →
    image homography fit and claiming candidates within ``tol_frac``·pitch
    of the predicted neighbour nodes.  The (cols·rows, 2) positions of a
    complete pattern window, or None."""
    N = len(cand)
    d = np.linalg.norm(cand[:, None] - cand[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(np.linalg.norm(cand - cand.mean(0), axis=1))
    d_sorted = np.sort(d, axis=1)
    pitch_global = float(np.median(d_sorted[:, 3]))

    for seed in order[: min(10, N)]:
        nn = np.argsort(d[seed])[:8]
        pairs = []
        vecs = [cand[j] - cand[seed] for j in nn
                if 0.5 * pitch_global < d[seed, j] < 1.5 * pitch_global]
        for a in range(len(vecs)):
            for b in range(a + 1, len(vecs)):
                va, vb = vecs[a], vecs[b]
                cosang = abs(va @ vb) / (
                    np.linalg.norm(va) * np.linalg.norm(vb)
                )
                if cosang < 0.5:
                    pairs.append((va, vb))
        for v1, v2 in pairs[:6]:
            pitch = min(np.linalg.norm(v1), np.linalg.norm(v2))
            out = _grow_from_basis(
                cand, d, seed, v1, v2, pitch, pattern_size, tol_frac
            )
            if out is not None:
                return out
    return None


def _grow_from_basis(cand, d, seed, v1, v2, pitch, pattern_size, tol_frac):
    cols, rows = pattern_size
    n = cols * rows
    assigned = {seed: (0, 0)}
    used = {seed}
    B = np.stack([v1, v2], axis=1)
    Hm = None
    changed = True
    while changed:
        changed = False
        coords = np.array([assigned[i] for i in assigned], dtype=np.float64)
        idxs = list(assigned.keys())
        pos = cand[idxs]
        if len(assigned) >= 6:
            Hm = cam_ops.homography_dlt(coords, pos)

        def predict(c):  # (n, 2) lattice coordinates → (n, 1, 2) pixels
            if Hm is not None:
                return cam_ops.apply_homography(Hm, c)[:, None]
            return (cand[seed] + c @ B.T)[:, None]

        taken = set(assigned.values())
        frontier = set()
        for i, (cx, cy) in assigned.items():
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                cc = (cx + dx, cy + dy)
                if cc not in taken:
                    frontier.add(cc)
        # every frontier node predicted at once (the fit is fixed within a
        # pass); the claims stay greedy, in the set's order
        frontier = list(frontier)
        dist_all = np.linalg.norm(
            cand[None] - predict(np.asarray(frontier, np.float64)), axis=-1)
        for cc, dists in zip(frontier, dist_all):
            dists[list(used)] = np.inf
            j = int(dists.argmin())
            if dists[j] < tol_frac * pitch:
                assigned[j] = cc
                used.add(j)
                changed = True

    if len(assigned) < 0.8 * n:
        return None
    coords = {assigned[i]: i for i in assigned}
    xs = [c[0] for c in coords]
    ys = [c[1] for c in coords]
    best_window = None
    best_support = -1
    for x0 in range(min(xs), max(xs) - cols + 2):
        for y0 in range(min(ys), max(ys) - rows + 2):
            support = sum(
                (x0 + i, y0 + j) in coords
                for j in range(rows)
                for i in range(cols)
            )
            if support > best_support:
                best_support = support
                best_window = (x0, y0)
    if best_window is None or best_support < n - max(n // 12, 2):
        return None
    x0, y0 = best_window
    out = np.zeros((n, 2), dtype=np.float64)
    for j in range(rows):
        for i in range(cols):
            cc = (x0 + i, y0 + j)
            if cc in coords:
                out[j * cols + i] = cand[coords[cc]]
            elif Hm is not None:
                out[j * cols + i] = cam_ops.apply_homography(
                    Hm, np.array([[cc[0], cc[1]]], dtype=np.float64))[0]
            else:
                out[j * cols + i] = cand[seed] + B @ np.array(cc, float)
    return out


def _dedupe(points: np.ndarray, radius: float = 2.0) -> np.ndarray:
    """Greedy merge of points closer than ``radius`` (keeps the first)."""
    kept = np.zeros((0, 2), points.dtype)
    for p in points:
        if (np.linalg.norm(kept - p, axis=1) > radius).all():
            kept = np.concatenate([kept, p[None]])
    return kept


def _xjunction_score(gray: np.ndarray, cand: np.ndarray, radius: float = 5.0,
                     n_samples: int = 16) -> np.ndarray:
    """Keep-mask: on a sampling ring around each candidate the 2nd angular
    harmonic (an X-junction) dominates the 1st (a T or L junction)."""
    img = gray.astype(np.float64)
    H, W = img.shape
    theta = 2 * np.pi * np.arange(n_samples) / n_samples
    dx = radius * np.cos(theta)
    dy = radius * np.sin(theta)
    xs = np.clip(cand[:, 0:1] + dx[None], 0, W - 2)
    ys = np.clip(cand[:, 1:2] + dy[None], 0, H - 2)
    x0 = np.floor(xs).astype(int)
    y0 = np.floor(ys).astype(int)
    fx = xs - x0
    fy = ys - y0
    s = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    s = s - s.mean(axis=1, keepdims=True)
    f1 = np.abs((s * np.exp(1j * theta)[None]).sum(axis=1))
    f2 = np.abs((s * np.exp(2j * theta)[None]).sum(axis=1))
    return f2 > 1.3 * f1


def _dominant_cluster(cand: np.ndarray, min_size: int):
    """Largest single-linkage cluster of candidates (linking radius 2.5×
    the median nearest-neighbour distance), or None below ``min_size``."""
    if len(cand) < min_size:
        return None
    d = np.linalg.norm(cand[:, None] - cand[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nn = d.min(axis=1)
    radius = 2.5 * np.median(nn)
    adj = d <= radius
    parent = np.arange(len(cand))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    ii, jj = np.nonzero(adj)
    for a, b in zip(ii, jj):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = np.array([find(i) for i in range(len(cand))])
    vals, counts = np.unique(roots, return_counts=True)
    best = vals[counts.argmax()]
    if counts.max() < min_size:
        return None
    return cand[roots == best]


def _quad_area(q: np.ndarray) -> float:
    return 0.5 * abs(sum(q[i, 0] * q[(i + 1) % 4, 1]
                         - q[(i + 1) % 4, 0] * q[i, 1] for i in range(4)))


def _quad_candidates(hull: np.ndarray, top_k: int = 12):
    """Hull 4-subsets as quads, ordered by area descending."""
    quads = [(_quad_area(hull[list(c)]), hull[list(c)])
             for c in combinations(range(len(hull)), 4)]
    quads.sort(key=lambda t: -t[0])
    return [q for _, q in quads[:top_k]]


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain (in place of ``cv2.convexHull``)."""
    pts = points[np.lexsort((points[:, 1], points[:, 0]))]

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2:
                a = out[-1] - out[-2]
                b = p - out[-2]
                if a[0] * b[1] - a[1] * b[0] > 0:  # strict left turn: keep
                    break
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _best_quad(hull: np.ndarray) -> np.ndarray:
    """The largest-area quadrilateral of hull vertices (≈ approxPolyDP of
    the board outline), exhaustive over the hull's 4-subsets."""
    best, best_area = None, -1.0
    for combo in combinations(range(len(hull)), 4):
        q = hull[list(combo)]
        area = _quad_area(q)
        if area > best_area:
            best_area, best = area, q
    return best


def _canonical_order(corners: np.ndarray, pattern_size) -> np.ndarray:
    """Orient the grid: row 0 on top (smaller mean y), column 0 on the
    left."""
    cols, rows = pattern_size
    grid = corners.reshape(rows, cols, 2)
    if grid[0, :, 1].mean() > grid[-1, :, 1].mean():
        grid = grid[::-1]
    if grid[:, 0, 0].mean() > grid[:, -1, 0].mean():
        grid = grid[:, ::-1]
    return grid.reshape(-1, 2)


# ---------------------------------------------------------------------------
# The manual-corner path (the reference's fallback when detection fails)
# ---------------------------------------------------------------------------


def sort_corners_clockwise(corners4: np.ndarray) -> np.ndarray:
    """Order 4 points clockwise (in image coordinates) from the top-left."""
    pts = np.asarray(corners4, dtype=np.float64).reshape(4, 2)
    center = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - center[1], pts[:, 0] - center[0])
    pts = pts[np.argsort(ang)]
    start = np.argmin(pts.sum(axis=1))
    return np.roll(pts, -start, axis=0)


def interpolate_image_points_from_corners(
    corners4: np.ndarray,
    pattern_size: Tuple[int, int] = (8, 6),
    corners_are_outer: bool = True,
) -> np.ndarray:
    """All (cols·rows, 2) inner corners, row-major, from 4 clicked corners
    through a homography; ``corners_are_outer``: the clicks are the board's
    physical corners (the inner lattice sits one square inside), else its
    extreme inner corners."""
    cols, rows = pattern_size
    quad = sort_corners_clockwise(corners4)
    if corners_are_outer:
        ideal_quad = np.array(
            [[0, 0], [cols + 1, 0], [cols + 1, rows + 1], [0, rows + 1]],
            dtype=np.float64)
        inner = np.array([[x, y] for y in range(1, rows + 1)
                          for x in range(1, cols + 1)], dtype=np.float64)
    else:
        ideal_quad = np.array(
            [[0, 0], [cols - 1, 0], [cols - 1, rows - 1], [0, rows - 1]],
            dtype=np.float64)
        inner = np.array([[x, y] for y in range(rows) for x in range(cols)],
                         dtype=np.float64)
    Hm = cam_ops.perspective_transform_4pt(ideal_quad, quad)
    return cam_ops.apply_homography(Hm, inner)


def extract_board_quad(bgr_image, bg_model_mask: Optional[np.ndarray] = None,
                       white_threshold: int = 175,
                       device="cuda") -> Optional[np.ndarray]:
    """The 4 outer board corners of a roughly segmented (H, W, 3) u8 BGR
    image: gray and histogram equalization on the image's device (a numpy
    image goes to ``device``), then on the host the white region's convex
    hull and its largest quad."""
    img = as_image(bgr_image, device)
    gray = color_ops.bgr_to_gray_u8(img)
    if bg_model_mask is not None:
        m = as_image(bg_model_mask, gray.device).to(gray.device)
        gray = torch.where(m > 0, gray, torch.zeros_like(gray))
    eq = color_ops.equalize_hist_u8(gray).cpu().numpy()
    ys, xs = np.nonzero(eq > white_threshold)
    if len(xs) < 100:
        return None
    pts = np.stack([xs, ys], axis=-1).astype(np.float64)
    if len(pts) > 4000:
        pts = pts[:: len(pts) // 4000]
    hull = _convex_hull(pts)
    if len(hull) < 4:
        return None
    quads = _quad_candidates(hull, top_k=1)
    return sort_corners_clockwise(quads[0]) if quads else None
