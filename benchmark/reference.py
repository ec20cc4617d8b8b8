"""The plain reference of the visual-hull step, in PyTorch, NumPy and
scipy.ndimage, independent of the program under test.

It computes from the benchmark's own inputs (the cameras, the background
sequences, the video frames) everything the program derives from them:

  * the per-camera MOG background model: OpenCV bgsegm's MOG update, one
    frame at a time, every multiply and add rounded on its own in the
    configured precision (``train_mog``);
  * each frame's raw masks: OpenCV's 8-bit BGR→HSV (fixed-point tables,
    rounding half to even) and the frozen model's decision (a pixel is
    background iff one of its first B = min(leading valid, k_fg) slots lies
    within ``match_sigma``² · Σvar of it; ``raw_masks``);
  * the mask cleanup: the optional 3×3 opening/closing, the contour
    hierarchy cleanup (8-connected foreground components of at least
    ``figure_threshold`` pixels, their holes re-carved where the hole's
    ``cv2.contourArea`` reaches ``inner_threshold`` and filled otherwise),
    the optional 2×2 opening/closing (``clean_masks``);
  * the carve: each voxel centre projected in the configured precision
    (OpenCV's 5-coefficient model, truncated pixel index), kept iff it is
    foreground in ``views_threshold`` cameras, coloured from the colour
    camera's pixel (``Projections``, ``carve``).

Nothing here imports the program.  Every tensor lives on the device it is
given; the connected components are labelled on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

FLT_EPSILON = float(np.float32(1.1920929e-07))
INITIAL_WEIGHT = 0.05  # OpenCV bgsegm defaultInitialWeight
DEFAULT_NOISE_SIGMA = 15.0  # OpenCV bgsegm defaultNoiseSigma

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


# -- colour ------------------------------------------------------------------

def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → (..., 3) u8 HSV as ``cv2.cvtColor(COLOR_BGR2HSV)``
    computes it: H in [0, 180), fixed point with a 12-bit shift."""
    b, g, r = (bgr[..., i].to(torch.int32) for i in range(3))
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    one = torch.ones_like(v)
    sdiv = torch.where(v > 0, torch.round(
        1044480.0 / torch.where(v > 0, v, one).to(torch.float32)), 0.0)
    hdiv = torch.where(diff > 0, torch.round(
        122880.0 / torch.where(diff > 0, diff, one).to(torch.float32)), 0.0)
    sdiv, hdiv = sdiv.to(torch.int32), hdiv.to(torch.int32)
    s = (diff * sdiv + 2048) >> 12
    hnum = torch.where(v == r, (g - b) * hdiv,
                       torch.where(v == g, (b - r + 2 * diff) * hdiv,
                                   (r - g + 4 * diff) * hdiv))
    h = (hnum + 2048) >> 12
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


# -- background model ----------------------------------------------------------

def train_mog(frames_bgr: torch.Tensor, mog: dict, dtype=torch.float32):
    """One camera's MOG model from (T, H, W, 3) u8 BGR frames on their
    device → (weight (P, K), mean (P, K, 3), varsum (P, K)) in ``dtype``,
    P = H·W, slots in OpenCV's storage order.

    Per frame: the learning rate is 1 / min(n, history); the first slot of
    the leading valid prefix within ``match_sigma``² · Σvar is updated and
    bubbled up past slots whose stored sort key is below its new key; with
    no match the slot after the prefix (the last slot if none is empty)
    becomes a new mode; weights and keys are then divided by their sum."""
    T, H, W, _ = frames_bgr.shape
    P, K = H * W, int(mog["n_mixtures"])
    dev = frames_bgr.device
    f = dict(dtype=dtype, device=dev)
    w = torch.zeros((K, P), **f)
    key = torch.zeros((K, P), **f)
    mu = torch.zeros((3, K, P), **f)
    var = torch.zeros((3, K, P), **f)
    kk = torch.arange(K, device=dev).reshape(K, 1)
    vt = float(np.float32(mog["match_sigma"] ** 2))
    min_var = float(np.float32(mog["noise_sigma"] ** 2))
    w0 = float(np.float32(INITIAL_WEIGHT))
    var0 = float(np.float32(4.0 * DEFAULT_NOISE_SIGMA ** 2))
    key0 = float(np.float32(INITIAL_WEIGHT / (2.0 * DEFAULT_NOISE_SIGMA)))
    src = bgr_to_hsv(frames_bgr) if mog["use_hsv"] else frames_bgr
    for t in range(T):
        x = src[t].reshape(P, 3).t().to(dtype)  # (3, P)
        n = torch.tensor(float(min(t + 1, int(mog["history"]))), **f)
        alpha = torch.ones_like(n) / n
        n_lead = torch.where(w < FLT_EPSILON, kk, K).amin(dim=0)
        d = x[:, None, :] - mu
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        vs = (var[0] + var[1]) + var[2]
        hit = (kk < n_lead) & (d2 < vt * vs)
        matched = hit.any(dim=0)
        c = torch.where(matched, torch.where(hit, kk, K).amin(dim=0), 0)
        w_new = w + alpha * (1.0 - w)
        mu_new = mu + alpha * d
        var_new = torch.clamp_min(var + alpha * (d * d - var), min_var)
        key_new = w_new / torch.sqrt(vs)
        ci = c[None]
        cw = torch.gather(w_new, 0, ci)[0]
        ck = torch.gather(key_new, 0, ci)[0]
        c3 = ci.expand(3, -1)[:, None]
        cmu = torch.gather(mu_new, 1, c3)[:, 0]
        cvar = torch.gather(var_new, 1, c3)[:, 0]
        pos = torch.where((kk < c) & (key >= ck), kk + 1, 0).amax(dim=0)
        at = (kk == pos) & matched
        moved = (kk > pos) & (kk <= c) & matched

        def bubble(a, val, axis):
            down = torch.cat([a.narrow(axis, 0, 1),
                              a.narrow(axis, 0, K - 1)], dim=axis)
            return torch.where(at, val.unsqueeze(axis),
                               torch.where(moved, down, a))

        w, key = bubble(w, cw, 0), bubble(key, ck, 0)
        mu, var = bubble(mu, cmu, 1), bubble(var, cvar, 1)
        fresh = ~matched & (kk == torch.clamp_max(n_lead, K - 1))
        w = torch.where(fresh, w0, w)
        key = torch.where(fresh, key0, key)
        mu = torch.where(fresh[None], x[:, None, :], mu)
        var = torch.where(fresh[None], var0, var)
        total = w[0]
        for k in range(1, K):
            total = total + w[k]
        scale = torch.ones_like(total) / total
        w, key = w * scale, key * scale
    varsum = (var[0] + var[1]) + var[2]
    return w.t().contiguous(), mu.permute(2, 1, 0).contiguous(), \
        varsum.t().contiguous()


def decision_slots(weight: torch.Tensor, bg_ratio: float) -> torch.Tensor:
    """(P, K) weights → (P,) B = min(leading valid slots, k_fg): the slots
    whose match makes a pixel background; the cumulative weight is summed
    slot after slot."""
    P, K = weight.shape
    kk = torch.arange(K, device=weight.device)
    n_lead = torch.where(weight < FLT_EPSILON, kk, K).amin(dim=1)
    ratio = float(np.float32(bg_ratio))
    cum = weight[:, 0]
    k_fg = torch.where(cum > ratio, 1, 0)
    for k in range(1, K):
        cum = cum + weight[:, k]
        k_fg = torch.where((k_fg == 0) & (cum > ratio), k + 1, k_fg)
    return torch.minimum(n_lead, k_fg)


def raw_masks(models, frames_bgr: torch.Tensor, mog: dict) -> torch.Tensor:
    """(C, H, W, 3) u8 frames + one trained model per camera → (C, H, W)
    bool foreground (no match among a pixel's decision slots)."""
    C, H, W, _ = frames_bgr.shape
    x_all = bgr_to_hsv(frames_bgr) if mog["use_hsv"] else frames_bgr
    vt = float(np.float32(mog["match_sigma"] ** 2))
    out = []
    for c in range(C):
        weight, mean, varsum = models[c]
        B = decision_slots(weight, mog["bg_ratio"])
        kmax = max(int(B.max()), 1)
        x = x_all[c].reshape(-1, 3).to(mean.dtype)
        d = x[:, None, :] - mean[:, :kmax]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        kk = torch.arange(kmax, device=d.device)
        bg = ((kk < B[:, None]) & (d2 < vt * varsum[:, :kmax])).any(dim=1)
        out.append((~bg).reshape(H, W))
    return torch.stack(out)


# -- mask cleanup -------------------------------------------------------------

def _window(m: torch.Tensor, k: int, fill: bool, op) -> torch.Tensor:
    """OpenCV's rectangular k×k erode (op=min, pad True) or dilate (op=max,
    pad False) of (H, W) bool, anchored at k // 2."""
    lo, hi = k // 2, k - 1 - k // 2
    p = torch.nn.functional.pad(m.to(torch.uint8), (lo, hi, lo, hi),
                                value=int(fill))
    H, W = m.shape
    out = p[0:H, 0:W]
    for dy in range(k):
        for dx in range(k):
            out = op(out, p[dy:dy + H, dx:dx + W])
    return out.bool()


def opening(m, k):
    return _window(_window(m, k, True, torch.minimum), k, False, torch.maximum)


def closing(m, k):
    return _window(_window(m, k, False, torch.maximum), k, True, torch.minimum)


def _corner_area4(bg: np.ndarray) -> np.ndarray:
    """Per 2×2 block of a padded (H+1, W+1) bool background image, 4× its
    share of ``cv2.contourArea`` of the background region it belongs to."""
    a, b = bg[:-1, :-1], bg[:-1, 1:]
    c, d = bg[1:, :-1], bg[1:, 1:]
    s = a.astype(np.int32) + b + c + d
    diag = (a & d & ~b & ~c) | (b & c & ~a & ~d)
    return ((s == 1) + 2 * ((s == 2) & ~diag) + 2 * diag + (s == 3)).astype(
        np.int64)


def hierarchy_cleanup(raw: np.ndarray, figure_threshold: float,
                      inner_threshold: float) -> np.ndarray:
    """(H, W) bool → (H, W) bool: foreground components (8-connected) of at
    least ``figure_threshold`` pixels kept solid; an enclosed background
    component that a kept pixel touches (3×3) is filled when its contour
    area (pixels + corner terms) is below ``inner_threshold``."""
    eight = np.ones((3, 3), bool)
    lf, nf = ndimage.label(raw, structure=eight)
    area_f = np.bincount(lf.ravel(), minlength=nf + 1)
    big = area_f >= figure_threshold
    big[0] = False
    kept = big[lf]
    bg = ~raw
    lb, nb = ndimage.label(bg, structure=eight)
    outside = np.zeros(nb + 1, bool)
    outside[np.concatenate([lb[0], lb[-1], lb[:, 0], lb[:, -1]])] = True
    area_b = np.bincount(lb.ravel(), minlength=nb + 1).astype(np.float64)
    lp = np.pad(lb, 1)
    block_label = np.maximum(np.maximum(lp[:-1, :-1], lp[:-1, 1:]),
                             np.maximum(lp[1:, :-1], lp[1:, 1:]))
    corner = np.bincount(block_label.ravel(),
                         weights=_corner_area4(np.pad(bg, 1)).ravel() / 4.0,
                         minlength=nb + 1)
    near_kept = ndimage.maximum_filter(kept, size=3, mode="constant",
                                       cval=False)
    touched = np.bincount(lb.ravel(), weights=near_kept.ravel(),
                          minlength=nb + 1) > 0
    fill = ~outside & touched & (area_b + corner < inner_threshold)
    fill[0] = False
    return kept | fill[lb]


def clean_masks(raw: torch.Tensor, mask_params) -> torch.Tensor:
    """(C, H, W) bool raw masks → (C, H, W) bool cleaned masks on their
    device: per camera the pre-morphology, the hierarchy cleanup on the
    host, the post-morphology."""
    out = []
    for c, p in enumerate(mask_params):
        m = raw[c]
        if p["opening_pre"]:
            m = opening(m, 3)
        if p["closing_pre"]:
            m = closing(m, 3)
        m = torch.from_numpy(hierarchy_cleanup(
            m.cpu().numpy(), p["figure_threshold"],
            p["inner_threshold"])).to(raw.device)
        if p["opening_post"]:
            m = opening(m, 2)
        if p["closing_post"]:
            m = closing(m, 2)
        out.append(m)
    return torch.stack(out)


# -- carve ---------------------------------------------------------------------

def _rotation(rvec) -> np.ndarray:
    """Rodrigues' formula in f64."""
    r = np.asarray(rvec, np.float64)
    theta = np.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    k = r / (theta if theta > 0 else 1.0)
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    eye = np.eye(3)
    if theta <= 1e-12:
        return eye + Kx * (theta if theta > 0 else 1.0)
    return eye + np.sin(theta) * Kx + (1.0 - np.cos(theta)) * (
        k[:, None] * k[None, :] - eye)


class Projections:
    """Each voxel centre's truncated pixel index per camera, in the grid's
    canonical (ix, iy, iz) order: ``lin`` (C, N) int64 (0 where outside the
    image) and ``valid`` (C, N) bool, on ``device``, projected in
    ``dtype``.  The centres are ``numpy.linspace`` over each axis."""

    def __init__(self, cameras, grid: dict, image_hw, device,
                 dtype=torch.float64):
        H, W = image_hw
        axes = [np.linspace(grid[f"{a}_min"], grid[f"{a}_max"], grid[f"n{a}"])
                for a in "xyz"]
        gx, gy, gz = torch.meshgrid(
            *[torch.from_numpy(a).to(device, dtype) for a in axes],
            indexing="ij")
        px, py, pz = gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)
        lins, valids = [], []
        for cam in cameras:
            R = _rotation(cam["rvec"])
            t, Kc, (k1, k2, p1, p2, k3) = cam["tvec"], cam["K"], cam["dist"][:5]
            X = [R[i, 0] * px + R[i, 1] * py + R[i, 2] * pz + t[i]
                 for i in range(3)]
            iz = 1.0 / X[2]
            xn, yn = X[0] * iz, X[1] * iz
            r2 = xn * xn + yn * yn
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            xy2 = 2.0 * xn * yn
            xd = xn * radial + p1 * xy2 + p2 * (r2 + 2.0 * xn * xn)
            yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + p2 * xy2
            u = Kc[0][0] * xd + Kc[0][2]
            v = Kc[1][1] * yd + Kc[1][2]
            ok = (v >= 0) & (v < H) & (u >= 0) & (u < W)
            lin = (torch.trunc(v).to(torch.int64) * W
                   + torch.trunc(u).to(torch.int64))
            lins.append(torch.where(ok, lin, 0))
            valids.append(ok)
            del X, iz, xn, yn, r2, radial, xy2, xd, yd, u, v
        self.lin = torch.stack(lins)
        self.valid = torch.stack(valids)
        self.image_hw = (H, W)


def carve(masks: torch.Tensor, frames_bgr: torch.Tensor, proj: Projections,
          views_threshold: int, color_camera: int):
    """(C, H, W) bool cleaned masks + (C, H, W, 3) u8 frames → (occupancy
    (N,) bool, colours (N, 3) u8 BGR, 0 off the hull)."""
    C = masks.shape[0]
    flat = masks.reshape(C, -1)
    count = torch.zeros(proj.lin.shape[1], dtype=torch.int32,
                        device=masks.device)
    for c in range(C):
        count += (proj.valid[c] & flat[c][proj.lin[c]]).to(torch.int32)
    occ = count >= views_threshold
    col = frames_bgr[color_camera].reshape(-1, 3)[proj.lin[color_camera]]
    return occ, torch.where(occ[:, None], col, 0).to(torch.uint8)
