"""Voxel carving on the plain table path and the fused path.

Counterpart of ``vbr_tpu/ops/carve.py``: the projection tables, built on
the device (``build_projection_tables(accelerate=True)``: an f32
projection, and a float64 host recheck of the voxels whose truncated index
or validity f32 rounding could flip) or on the host in float64
(``_build_tables_f64``, the exactness oracle: float bounds check,
truncate-toward-zero pixel index), both bit-identical;
``exact_truncated_projections``, the per-frame table carve
``carve_from_tables``, its loop over a batch of frames
``carve_frames_batched``, the table-free f32 carve ``carve_fused`` and the
host viewer compaction ``compact_voxels``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.utils.config import CameraParams, GridConfig
from vbr_tpu_torch.utils.device import resolve_device

_SUS_EPS = 2e-3  # px; far above the f32 projection error (~1e-4 px at 644 px)
_SUS_Z_EPS = 8.0  # mm of camera-frame depth below which f32 1/Xz blows up
# The band is widened to this many times :func:`_f32_error_px` where that is
# wider than _SUS_EPS: far off the optical axis the distortion polynomial's
# terms cancel and the f32 error reaches 0.04 px (the calibration poses of
# artifacts/intrinsics_run), where a fixed band misses index flips.  On
# those poses, the rig and the synthetic rig at 128³ the error stayed below
# 0.59 of the estimate on every voxel (scripts/check_suspicion_band.py).
_ERR_MARGIN = 4.0
_F32_UNIT = 2.0 ** -24  # unit roundoff of float32
# voxels per slab of the device builds: the x-planes of one slab project at
# once, so their f32 temporaries stay ~1 GB at any grid size
CHUNK_VOXELS = 1 << 24


class ProjectionTables(NamedTuple):
    """Static per-rig carving tables.

    valid:    (C, N) bool   — projection inside the image (float-coord test)
    lin_idx:  (C, N) int32  — truncated y*W + x (0 where invalid)
    """

    valid: torch.Tensor
    lin_idx: torch.Tensor
    image_hw: Tuple[int, int]


def _build_tables_f64(cameras: Sequence[CameraParams], grid: GridConfig,
                      image_hw) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-host float64 tables: (valid (C, N) bool, lin_idx (C, N) i32)."""
    H, W = image_hw
    pts = grid.voxel_points()
    valids, idxs = [], []
    for cp in cameras:
        uv = cam_ops.project_points(pts, cp.rvec, cp.tvec, cp.K, cp.dist)
        x, y = uv[:, 0], uv[:, 1]
        valid = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        ix = np.trunc(x).astype(np.int64)
        iy = np.trunc(y).astype(np.int64)
        lin = np.where(valid, iy * W + ix, 0).astype(np.int32)
        valids.append(valid)
        idxs.append(lin)
    return np.stack(valids), np.stack(idxs)


def _camera_f32(cp: CameraParams, device):
    """(rvec, tvec, K, dist) as f32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                 for a in (cp.rvec, cp.tvec, cp.K, cp.dist))


def _proj_suspicion_chunk(xc, ys, zs, rvec, tvec, K, dist, hw):
    """f32 truncated projection of the x-slab ``xc`` × ``ys`` × ``zs`` (f32
    axis samples on one device) → flat canonical (iy, ix) i32 (0 where
    invalid), valid and suspicious bool.

    A voxel is suspicious where f32 rounding could flip its truncated index
    or its validity: within ``_SUS_EPS`` of a pixel or image boundary (or
    ``_ERR_MARGIN`` times its estimated f32 error, where that is wider), or
    within ``_SUS_Z_EPS`` of the camera's principal plane, where 1/Xz is
    ill-conditioned.  Every other voxel equals the f64 projection."""
    h, w = hw
    gx, gy, gz = torch.meshgrid(xc, ys, zs, indexing="ij")
    pts = torch.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    R = cam_ops.rodrigues(rvec)
    uv = cam_ops.project_points_rt(pts, R, tvec, K, dist)
    x, y = uv[:, 0], uv[:, 1]
    fx = x - torch.floor(x)
    fy = y - torch.floor(y)
    # the camera frame, elementwise as in the projection (a matmul could
    # run in TF32)
    Xc = [R[i, 0] * pts[:, 0] + R[i, 1] * pts[:, 1] + R[i, 2] * pts[:, 2]
          + tvec[i] for i in range(3)]
    ex, ey = (torch.clamp(_ERR_MARGIN * e, min=_SUS_EPS)
              for e in _f32_error_px(pts, Xc, tvec, K, dist, x, y))
    suspicious = (
        (fx < ex) | (fx > 1 - ex) | (fy < ey) | (fy > 1 - ey)
        | (x.abs() < ex) | ((x - w).abs() < ex)
        | (y.abs() < ey) | ((y - h).abs() < ey)
        | (Xc[2].abs() < _SUS_Z_EPS)
    )
    valid = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    iy = torch.where(valid, torch.trunc(y), 0).to(torch.int32)
    ix = torch.where(valid, torch.trunc(x), 0).to(torch.int32)
    return iy, ix, valid, suspicious


def _f32_error_px(pts, Xc, tvec, K, dist, x, y):
    """Per voxel, a first-order estimate (in px, along x and y) of how far
    the f32 projection can lie from the f64 one: the rounding of R·p + t
    (relative to |p|₁ + |t|₁) carried through the division by Xz and the
    distortion polynomial's slope, plus that of the last multiply-add."""
    az = Xc[2].abs()
    an = (Xc[0].abs() + Xc[1].abs()) / az  # |xn| + |yn|
    r2 = (Xc[0] * Xc[0] + Xc[1] * Xc[1]) / (az * az)
    k1, k2, p1, p2, k3 = dist.abs().unbind()
    slope = (1 + r2 * (3 * k1 + r2 * (5 * k2 + 7 * k3 * r2))
             + 6 * (p1 + p2) * an)
    scale = pts.abs().sum(dim=1) + tvec.abs().sum()
    e = _F32_UNIT * slope * (scale * (2 + an) / az + an)
    return (K[0, 0] * e + _F32_UNIT * (x.abs() + 2 * K[0, 2].abs()),
            K[1, 1] * e + _F32_UNIT * (y.abs() + 2 * K[1, 2].abs()))


def _exact_f64(cp: CameraParams, axes, gidx: np.ndarray, image_hw):
    """The f64 host projection of the canonical voxels ``gidx`` →
    (iy, ix) i32 (0 where invalid) and valid, numpy.  Their points come
    from the axis samples ``axes`` (what ``voxel_points()`` holds at those
    rows), so no (N, 3) grid is made."""
    H, W = image_hw
    xs, ys, zs = axes
    ny, nz = len(ys), len(zs)
    pts = np.stack([xs[gidx // (ny * nz)], ys[(gidx // nz) % ny],
                    zs[gidx % nz]], axis=-1)
    uv = cam_ops.project_points(pts, cp.rvec, cp.tvec, cp.K, cp.dist)
    x, y = uv[:, 0], uv[:, 1]
    valid = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    iy = np.where(valid, np.trunc(y), 0).astype(np.int32)
    ix = np.where(valid, np.trunc(x), 0).astype(np.int32)
    return iy, ix, valid


def _apply_corrections(iy, ix, valid, sidx, iy_e, ix_e, valid_e):
    """Write the f64 values of the voxels ``sidx`` (numpy, flat in the
    slab) over the f32 ones, in place."""
    idx = torch.from_numpy(sidx).to(iy.device)
    for dst, src in ((iy, iy_e), (ix, ix_e), (valid, valid_e)):
        dst[idx] = torch.from_numpy(src).to(dst.device)


def _exact_slabs(cp: CameraParams, grid: GridConfig, image_hw, planes: int,
                 device) -> Iterator[tuple]:
    """The exact truncated projection of one camera, slab by slab of
    ``planes`` x-planes: (first x-plane, iy, ix, valid) per slab, flat in
    canonical order on ``device``.  The f32 projection runs on the device;
    only the suspicious voxels' indices come to the host, are re-projected
    in f64 and written back."""
    axes = grid.axis_ranges()
    ys, zs = (torch.from_numpy(a.astype(np.float32)).to(device)
              for a in axes[1:])
    cam = _camera_f32(cp, device)
    for x0 in range(0, grid.nx, planes):
        xc = torch.from_numpy(axes[0][x0:x0 + planes].astype(np.float32))
        iy, ix, valid, sus = _proj_suspicion_chunk(
            xc.to(device), ys, zs, *cam, tuple(image_hw))
        sidx = torch.nonzero(sus).squeeze(1).cpu().numpy()
        if len(sidx):
            _apply_corrections(iy, ix, valid, sidx, *_exact_f64(
                cp, axes, sidx + x0 * grid.ny * grid.nz, image_hw))
        yield x0, iy, ix, valid


def _slab_planes(grid: GridConfig) -> int:
    return max(1, CHUNK_VOXELS // (grid.ny * grid.nz))


def build_projection_tables(cameras: Sequence[CameraParams], grid: GridConfig,
                            image_hw, accelerate: bool = True,
                            device="cuda") -> ProjectionTables:
    """Each voxel's truncated pixel index per camera, on ``device``,
    bit-identical to the f64 host projection.

    ``accelerate=True`` projects in f32 on ``device``, slab by slab, and
    re-projects in f64 on the host only the suspicious voxels (see
    :func:`_proj_suspicion_chunk`; ~0.1-1 % of them); ``False`` is the
    pure f64 host build (the oracle), moved to ``device``."""
    device = resolve_device(device)
    if not accelerate:
        valid, lin = _build_tables_f64(cameras, grid, image_hw)
        return ProjectionTables(
            valid=torch.from_numpy(valid).to(device),
            lin_idx=torch.from_numpy(lin).to(device),
            image_hw=tuple(image_hw),
        )
    W = image_hw[1]
    C, N, plane = len(cameras), grid.num_voxels, grid.ny * grid.nz
    valid = torch.empty((C, N), dtype=torch.bool, device=device)
    lin = torch.empty((C, N), dtype=torch.int32, device=device)
    for c, cp in enumerate(cameras):
        for x0, iy, ix, v in _exact_slabs(cp, grid, image_hw,
                                          _slab_planes(grid), device):
            rows = slice(x0 * plane, x0 * plane + v.numel())
            valid[c, rows] = v
            lin[c, rows] = iy * W + ix
    return ProjectionTables(valid=valid, lin_idx=lin,
                            image_hw=tuple(image_hw))


def exact_truncated_projections(cp: CameraParams, grid: GridConfig,
                                image_hw, device="cuda"):
    """One camera's per-voxel (iy, ix, valid) as host numpy (int64, int64,
    bool; 0 where invalid), with the reference's f64 + ``int()``
    truncation, by the device build of :func:`build_projection_tables`."""
    device = resolve_device(device)
    parts = [tuple(t.cpu() for t in slab[1:]) for slab in _exact_slabs(
        cp, grid, image_hw, _slab_planes(grid), device)]
    iy, ix, valid = (torch.cat(ts).numpy() for ts in zip(*parts))
    return iy.astype(np.int64), ix.astype(np.int64), valid


def view_counts(masks: torch.Tensor, valid: torch.Tensor,
                lin_idx: torch.Tensor) -> torch.Tensor:
    """(N,) i32: how many of the (C, H, W) ``masks`` see each voxel, from
    its (C, N) projection tables."""
    C = masks.shape[0]
    masks_flat = masks.reshape(C, -1)
    count = torch.zeros(valid.shape[1], dtype=torch.int32, device=masks.device)
    for c in range(C):  # one camera's i64 indices at a time
        count += (valid[c] & (masks_flat[c][lin_idx[c].long()] > 0)).to(
            torch.int32)
    return count


def carve_from_tables(
    masks: torch.Tensor,  # (C, H, W) u8 foreground masks
    images: torch.Tensor,  # (C, H, W, 3) u8 BGR frames
    valid: torch.Tensor,  # (C, N) bool
    lin_idx: torch.Tensor,  # (C, N) int32
    *,
    views_threshold: int = 4,
    color_camera: int = 1,
):
    """Per-frame carve: C mask gathers + view count + colour gather.

    Returns (occupancy (N,) bool, colors (N, 3) u8 BGR).  Like the JAX
    table path, an invalid projection of the colour camera reads pixel
    (0, 0) (only occupied voxels' colours are ever consumed)."""
    occupancy = view_counts(masks, valid, lin_idx) >= views_threshold
    colors = images[color_camera].reshape(-1, 3)[lin_idx[color_camera].long()]
    return occupancy, colors


def carve_frames_batched(
    masks: torch.Tensor,  # (F, C, H, W) u8
    images: torch.Tensor,  # (F, C, H, W, 3) u8
    valid: torch.Tensor,
    lin_idx: torch.Tensor,
    *,
    views_threshold: int = 4,
    color_camera: int = 1,
):
    """:func:`carve_from_tables` over a batch of F frames →
    (occupancy (F, N) bool, colors (F, N, 3) u8)."""
    outs = [carve_from_tables(m, im, valid, lin_idx,
                              views_threshold=views_threshold,
                              color_camera=color_camera)
            for m, im in zip(masks, images)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([c for _, c in outs]))


def _pose_arrays(cameras: Sequence[CameraParams], device="cuda"):
    """The cameras as f32 tensors on ``device`` for :func:`carve_fused`:
    (R (C, 3, 3) from the f64 Rodrigues, t (C, 3), K4 (C, 4) = fx, fy, cx,
    cy, dist (C, 5))."""
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return (f32(np.stack([cam_ops.rodrigues(cp.rvec) for cp in cameras])),
            f32(np.stack([cp.tvec for cp in cameras])),
            f32([[cp.fx, cp.fy, cp.cx, cp.cy] for cp in cameras]),
            f32(np.stack([cp.dist for cp in cameras])))


def voxel_points_f32(grid: GridConfig, device="cuda") -> torch.Tensor:
    """(N, 3) f32 voxel centres on ``device``: ``grid.voxel_points()``
    cast to f32, made on the device from the f32 axis samples (the same
    values, without the f64 grid on the host)."""
    axes = (torch.from_numpy(a.astype(np.float32)).to(device)
            for a in grid.axis_ranges())
    return torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       axis=-1).reshape(-1, 3)


def carve_fused(
    masks: torch.Tensor,  # (C, H, W) u8
    images: torch.Tensor,  # (C, H, W, 3) u8
    points: torch.Tensor,  # (N, 3) f32 voxel centres
    R: torch.Tensor,  # (C, 3, 3) f32
    t: torch.Tensor,  # (C, 3) f32
    K4: torch.Tensor,  # (C, 4) f32 fx fy cx cy
    dist: torch.Tensor,  # (C, 5) f32
    *,
    image_hw: Tuple[int, int],
    views_threshold: int = 4,
    color_camera: int = 1,
):
    """Table-free carve: project → distort → gather → count, in f32, one
    camera at a time (so each temporary holds one camera), one eager
    operation per step (rounded as ``vbr_tpu`` rounds without ``jit``).

    Returns (occupancy (N,) bool, colors (N, 3) u8 BGR).  Occupancy equals
    the f64 table path except at voxels that project within f32 rounding
    of a pixel or image boundary."""
    H, W = image_hw
    C = masks.shape[0]
    masks_flat = masks.reshape(C, -1)
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    count = torch.zeros(points.shape[0], dtype=torch.int32,
                        device=points.device)
    for c in range(C):
        Rc, tc, K4c = R[c], t[c], K4[c]
        Xx = Rc[0, 0] * px + Rc[0, 1] * py + Rc[0, 2] * pz + tc[0]
        Xy = Rc[1, 0] * px + Rc[1, 1] * py + Rc[1, 2] * pz + tc[1]
        Xz = Rc[2, 0] * px + Rc[2, 1] * py + Rc[2, 2] * pz + tc[2]
        inv_z = 1.0 / Xz
        xd, yd = cam_ops.distort_normalized(Xx * inv_z, Xy * inv_z, dist[c])
        u = K4c[0] * xd + K4c[2]
        v = K4c[1] * yd + K4c[3]
        valid = (v >= 0) & (v < H) & (u >= 0) & (u < W)
        lin = torch.where(valid, torch.trunc(v).to(torch.int32) * W
                          + torch.trunc(u).to(torch.int32), 0).long()
        count += (valid & (masks_flat[c][lin] > 0)).to(torch.int32)
        if c == color_camera:
            lin_color = lin
    occupancy = count >= views_threshold
    colors = images[color_camera].reshape(-1, 3)[lin_color]
    return occupancy, colors


def compact_voxels(occupancy, colors, grid: GridConfig,
                   scaling_factor: float = 64.0):
    """Host compaction into the viewer contract: truncated world positions
    with the (x, -z, y)/scale axis swap, and BGR→RGB colours in [0, 1].

    Returns (positions (M, 3) float32, colors (M, 3) float32) numpy."""
    occupancy = to_host(occupancy).astype(bool)
    return viewer_arrays(grid.voxel_points()[occupancy],
                         to_host(colors)[occupancy], scaling_factor)


def viewer_arrays(points, colors_bgr, scaling_factor: float = 64.0):
    """(M, 3) world points + (M, 3) u8 BGR → viewer positions (int()
    truncation, then (x, -z, y) / scale) and RGB colours in [0, 1]."""
    kept = np.trunc(points)
    positions = np.stack(
        [
            kept[:, 0] / scaling_factor,
            -(kept[:, 2] / scaling_factor),
            kept[:, 1] / scaling_factor,
        ],
        axis=-1,
    ).astype(np.float32)
    rgb = colors_bgr[:, ::-1].astype(np.float32) / 255.0
    return positions, rgb


def to_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
