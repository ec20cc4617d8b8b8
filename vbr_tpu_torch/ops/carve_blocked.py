"""Blocked visual-hull carve (kernels K1 and K4) and its static tables.

Counterpart of ``vbr_tpu/ops/carve_pallas.py``:

  * the static tables — ``BlockTables``, ``_blocked_permutation``,
    ``_check_block_geometry``, ``build_block_tables`` (the device build
    ``build_block_tables_device`` from 2²⁴ voxels, the pure-f64 host build
    below; both bit-identical to the f64 projection), the device build's
    f64 spot check ``_spot_check`` and ``tables_static_tuple``; the
    suspicion bands and the f64 recheck that both device builds share
    (``_SUS_EPS``, ``_SUS_Z_EPS``, ``_proj_suspicion_chunk``,
    ``_apply_corrections``, which ``vbr_tpu`` keeps in this module) are in
    ``ops/carve.py``;
  * device side — ``block_activity`` (per-sub-block active/full flags from
    8×8 fine cells and the bilinear row/column span form, in float32
    matmuls whose 0/1 sums are exact), the carve kernel, and the
    blocked/canonical output handling of ``carve_blocked``;
  * the offline multi-frame carve — ``carve_frames_blocked``: kernel K4
    (``csrc/carve_frames.cu``) carves ``frames_per_launch`` frames per
    launch, occupancy only; ``chunk_colors_device`` gathers the colours
    of a chunk's occupied voxels on the device, ``frame_colors_host`` one
    frame's on the host;
  * host helpers for the blocked layout — ``canonicalize_host`` and
    ``compact_voxels_blocked``;
  * the packed viewer wire — ``pack_blocked_outputs`` and ``encode_wire``
    on the device (one u8 buffer per frame: a bitmap of each occupied
    sub-block and the colours of the occupied voxels), ``decode_wire`` and
    ``viewer_arrays_from_packed`` on the host.

The voxel grid is tiled into 8³ sub-blocks (512 voxels) grouped into
superblocks; ``perm`` maps each (superblock, sub-block, voxel) slot to its
canonical voxel index.  On a CUDA tensor a carve runs its hand-written
kernel; on a CPU tensor its plain PyTorch version.  Both emit final u8
occupancy (and K1 u8 BGR colours).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.ops import marching_cubes as mc
from vbr_tpu_torch.ops._cuda import CudaKernel, check, ptr
from vbr_tpu_torch.ops.carve import (_exact_f64, _exact_slabs, to_host,
                                     viewer_arrays)
from vbr_tpu_torch.utils.config import CameraParams, GridConfig
from vbr_tpu_torch.utils.device import resolve_device

BV = 512  # voxels per sub-block (8³)
WORD_BITS = 8  # columns per packed word in the geometry word ``pk``
LANE = 128  # fine-cell span padding (kept from the JAX tables)
FCELL = 8  # activity/full-test fine-cell size in pixels
INVALID_ROW = 1023  # ``pk`` row of a projection outside the image
# build_block_tables(accelerate=None) builds on the device from here (256³)
DEVICE_BUILD_VOXELS = 1 << 24
SPOT_CHECK_VOXELS = 2048  # voxels the device build re-projects in f64

# both include csrc/carve_common.cuh (copy helpers, mask gather, the
# persistent walk and its launch plan)
K1 = CudaKernel(
    "carve_blocked.cu", "vbr_carve_blocked",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    deps=["carve_common.cuh"],
)
K4 = CudaKernel(
    "carve_frames.cu", "vbr_carve_frames",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    deps=["carve_common.cuh"],
)


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BlockTables:
    """Static per-rig tables of the blocked carve (see the JAX class)."""

    grid_shape: Tuple[int, int, int]
    sub_shape: Tuple[int, int, int]
    sup_shape: Tuple[int, int, int]  # in sub-blocks
    nblocks: Tuple[int, int, int]  # superblock grid (gx, gy, gz)
    nsuper: int
    nsub: int
    num_cameras: int
    image_hw: Tuple[int, int]
    Hp: int
    n_words: int
    Wc: int
    WH: int
    WC: int
    color_camera: int
    # packed geometry, one i32 per (voxel, camera): row<<10 | word<<3 | bit
    pk: torch.Tensor = None  # (nsuper, nsub, C, BV) i32
    lcc: torch.Tensor = None  # (nsuper, nsub, BV) i32 colour col, -1 invalid
    vorig: torch.Tensor = None  # (nsuper, nsub, C) i32 row-window origin
    uorig: torch.Tensor = None  # (nsuper, nsub, 1) i32 colour col origin
    allv: torch.Tensor = None  # (nsuper, nsub) i32 all projections valid
    ry: torch.Tensor = None  # (C, nsuper*nsub, hf_pad) f32 row spans
    rx: torch.Tensor = None  # (C, nsuper*nsub, wf_pad) f32 col spans
    n_fcells_hw: Tuple[int, int] = (0, 0)
    perm: np.ndarray = dataclasses.field(default=None, compare=False,
                                         hash=False)


def _blocked_permutation(grid_shape, sub, sup):
    """Canonical (ix, iy, iz) C-order → (superblock, sub-block, voxel)."""
    nx, ny, nz = grid_shape
    sbx, sby, sbz = sub
    spx, spy, spz = sup
    gx, gy, gz = nx // (sbx * spx), ny // (sby * spy), nz // (sbz * spz)
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    idx = idx.reshape(gx, spx, sbx, gy, spy, sby, gz, spz, sbz)
    idx = idx.transpose(0, 3, 6, 1, 4, 7, 2, 5, 8)
    perm = idx.reshape(gx * gy * gz, spx * spy * spz, sbx * sby * sbz)
    return perm, (gx, gy, gz)


def _check_block_geometry(grid, sub, sup, image_hw):
    H, W = image_hw
    for n, s, p in zip(grid.shape, sub, sup):
        if n % (s * p) != 0:
            raise ValueError(f"grid dim {n} not divisible by {s}*{p}")
    if sub[0] * sub[1] * sub[2] != BV:
        raise ValueError("sub-block must contain exactly 512 voxels")
    if W // WORD_BITS >= 128:
        raise ValueError("word index must fit 7 bits (image width < 1024)")
    if H >= INVALID_ROW:
        raise ValueError("image height must be < 1023 (row 1023 is the "
                         "packed-geometry invalid sentinel)")


def build_block_tables(
    cameras: Sequence[CameraParams],
    grid: GridConfig,
    image_hw: Tuple[int, int],
    sub: Tuple[int, int, int] = (8, 8, 8),
    sup: Tuple[int, int, int] = (2, 2, 4),
    color_camera: int = 1,
    accelerate: bool | None = None,
    device="cuda",
) -> BlockTables:
    """All static carve tables on ``device``, bit-identical to the pure
    f64 host projection.

    ``accelerate=True`` is :func:`build_block_tables_device` (f32
    projection on ``device``, f64 host recheck of the suspicious voxels);
    ``False`` the pure f64 host build (the oracle), moved to ``device``;
    ``None`` takes the device build at ``DEVICE_BUILD_VOXELS`` voxels and
    up (256³), where the host build takes minutes, and the host build
    below."""
    device = resolve_device(device)
    if accelerate is None:
        accelerate = grid.num_voxels >= DEVICE_BUILD_VOXELS
    build = (build_block_tables_device if accelerate
             else _build_block_tables_f64)
    return build(cameras, grid, image_hw, sub=sub, sup=sup,
                 color_camera=color_camera, device=device)


def _build_block_tables_f64(cameras, grid, image_hw, sub, sup, color_camera,
                            device) -> BlockTables:
    """The pure f64 host build (the exactness oracle), moved to
    ``device``."""
    H, W = image_hw
    C = len(cameras)
    _check_block_geometry(grid, sub, sup, image_hw)

    perm, nblocks = _blocked_permutation(grid.shape, sub, sup)
    nsuper, nsub, _ = perm.shape
    n_words = _ceil_to(W, WORD_BITS) // WORD_BITS
    pk = np.zeros((nsuper, nsub, C, BV), dtype=np.int32)
    vorig = np.zeros((nsuper, nsub, C), dtype=np.int32)
    allv = np.ones((nsuper, nsub), dtype=bool)
    nblk = nsuper * nsub
    hf = -(-H // FCELL)
    wf = -(-W // FCELL)
    hf_p = _ceil_to(hf, LANE)
    wf_p = _ceil_to(wf, LANE)
    ry = np.zeros((C, nblk, hf_p), dtype=np.int8)
    rx = np.zeros((C, nblk, wf_p), dtype=np.int8)

    pts = grid.voxel_points()
    need_wh = 8
    for c, cp in enumerate(cameras):
        uv = cam_ops.project_points(pts, cp.rvec, cp.tvec, cp.K, cp.dist)
        x, y = uv[:, 0], uv[:, 1]
        valid = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        iy_b = np.where(valid, np.trunc(y), 0).astype(np.int32)[perm]
        ix_b = np.where(valid, np.trunc(x), 0).astype(np.int32)[perm]
        valid_b = valid[perm]
        if c == color_camera:
            ix_color, valid_color = ix_b, valid_b
        pk[:, :, c, :] = _pk_words(np.where(valid_b, iy_b, INVALID_ROW),
                                   ix_b)

        allv &= valid_b.all(axis=2)
        any_v = valid_b.any(axis=2)
        ymin = np.where(any_v, np.where(valid_b, iy_b, 10**6).min(axis=2), 0)
        ymax = np.where(any_v, np.where(valid_b, iy_b, -1).max(axis=2), 0)
        v0 = (ymin // 8) * 8
        need_wh = max(need_wh, int((ymax - v0).max()) + 1)
        vorig[:, :, c] = v0

        # footprint bbox → fine row/column span indicators
        xmin_c = np.where(any_v, np.where(valid_b, ix_b, 10**6).min(axis=2), 0)
        xmax_c = np.where(any_v, np.where(valid_b, ix_b, -1).max(axis=2), 0)
        bidx = np.flatnonzero(any_v.ravel())
        y0F, y1F = (ymin // FCELL).ravel(), (ymax // FCELL).ravel()
        x0F, x1F = (xmin_c // FCELL).ravel(), (xmax_c // FCELL).ravel()
        dy = np.zeros((nblk, hf_p + 1), np.int8)
        np.add.at(dy, (bidx, y0F[bidx]), 1)
        np.add.at(dy, (bidx, y1F[bidx] + 1), -1)
        ry[c] = np.cumsum(dy, axis=1, dtype=np.int8)[:, :hf_p]
        dx = np.zeros((nblk, wf_p + 1), np.int8)
        np.add.at(dx, (bidx, x0F[bidx]), 1)
        np.add.at(dx, (bidx, x1F[bidx] + 1), -1)
        rx[c] = np.cumsum(dx, axis=1, dtype=np.int8)[:, :wf_p]

    WH = _ceil_to(need_wh, 8)
    Hp = _ceil_to(H, 8) + WH
    any_c = valid_color.any(axis=2)
    xmin = np.where(any_c, np.where(valid_color, ix_color, 10**6).min(axis=2), 0)
    xmax = np.where(any_c, np.where(valid_color, ix_color, -1).max(axis=2), 0)
    u0 = (xmin // 64) * 64
    WC = _ceil_to(int((xmax - u0).max()) + 1, LANE)
    Wc = _ceil_to(W, LANE) + WC
    uorig = u0.astype(np.int32).reshape(nsuper, nsub, 1)
    lcc = np.where(valid_color, ix_color, -1).astype(np.int32)

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    return BlockTables(
        grid_shape=grid.shape, sub_shape=tuple(sub), sup_shape=tuple(sup),
        nblocks=nblocks, nsuper=nsuper, nsub=nsub, num_cameras=C,
        image_hw=(H, W), Hp=Hp, n_words=n_words, Wc=Wc, WH=WH, WC=WC,
        color_camera=color_camera,
        pk=dev(pk), lcc=dev(lcc), vorig=dev(vorig), uorig=dev(uorig),
        allv=dev(allv.astype(np.int32)),
        ry=dev(ry, torch.float32), rx=dev(rx, torch.float32),
        n_fcells_hw=(hf, wf), perm=perm,
    )


def _pk_words(row, ix):
    """The packed geometry word ``row<<10 | word<<3 | bit`` (numpy or
    torch; ``row`` holds ``INVALID_ROW`` where the projection is
    invalid)."""
    return (row << 10) | ((ix // WORD_BITS) << 3) | (ix % WORD_BITS)


def _spans(any_v, lo, hi, lanes):
    """(nblk, lanes) f32: 1 on the fine cells ``lo // FCELL`` to
    ``hi // FCELL`` of each block with a valid projection."""
    return (any_v.reshape(-1, 1) & (lanes >= (lo // FCELL).reshape(-1, 1))
            & (lanes <= (hi // FCELL).reshape(-1, 1))).to(torch.float32)


def _extent(a, valid, any_v):
    """Per block, the min and max of ``a`` over its valid voxels (0 and 0
    for a block with none), as the host build takes them."""
    lo = torch.where(valid, a, 10 ** 6).amin(dim=2)
    hi = torch.where(valid, a, -1).amax(dim=2)
    return torch.where(any_v, lo, 0), torch.where(any_v, hi, 0)


def build_block_tables_device(
    cameras: Sequence[CameraParams],
    grid: GridConfig,
    image_hw: Tuple[int, int],
    sub: Tuple[int, int, int] = (8, 8, 8),
    sup: Tuple[int, int, int] = (2, 2, 4),
    color_camera: int = 1,
    chunk_voxels: int = 1 << 24,
    device="cuda",
) -> BlockTables:
    """All static carve tables built on ``device``, bit-identical to the
    f64 host build.

    The build is chunked over the outermost superblock axis (about
    ``chunk_voxels`` voxels a chunk): a range of it is a contiguous slice of
    the canonical voxels and of every (nsuper, ...) table, so no temporary
    grows with the grid.  Per (camera, chunk): the f32 projection on the
    device, an f64 host recheck of the suspicious voxels only
    (``carve._exact_slabs``), then blocking (a reshape and permute), the
    packed word, the row windows, the activity spans and the colour tables,
    written into the preallocated tables by slice assignment.  Only the
    window sizes WH and WC come to the host.  At the end
    :func:`_spot_check` re-projects a sample of voxels in f64 and raises
    ``AssertionError`` where a word differs (a rig outside the suspicion
    bands' envelope: build with ``accelerate=False``)."""
    device = resolve_device(device)
    H, W = image_hw
    C = len(cameras)
    _check_block_geometry(grid, sub, sup, image_hw)
    perm, nblocks = _blocked_permutation(grid.shape, sub, sup)
    nsuper, nsub, _ = perm.shape
    nblk = nsuper * nsub
    hf, wf = -(-H // FCELL), -(-W // FCELL)
    hf_p, wf_p = _ceil_to(hf, LANE), _ceil_to(wf, LANE)
    gx, gy, gz = nblocks
    x_per_gx = sub[0] * sup[0]  # canonical x-planes per superblock slab
    cg = max(1, min(gx, chunk_voxels // (x_per_gx * grid.ny * grid.nz)))
    while gx % cg:
        cg -= 1
    nsuper_c = cg * gy * gz  # superblocks per chunk

    def to_blocked(a):  # a chunk's canonical voxels → (nsuper_c, nsub, BV)
        return a.reshape(cg, sup[0], sub[0], gy, sup[1], sub[1], gz, sup[2],
                         sub[2]).permute(0, 3, 6, 1, 4, 7, 2, 5, 8).reshape(
            nsuper_c, nsub, BV)

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    pk, vorig = empty((nsuper, nsub, C, BV)), empty((nsuper, nsub, C))
    lcc, uorig = empty((nsuper, nsub, BV)), empty((nsuper, nsub, 1))
    ry = empty((C, nblk, hf_p), torch.float32)
    rx = empty((C, nblk, wf_p), torch.float32)
    allv = torch.ones((nsuper, nsub), dtype=torch.bool, device=device)
    lanes_h = torch.arange(hf_p, dtype=torch.int32, device=device)
    lanes_w = torch.arange(wf_p, dtype=torch.int32, device=device)
    # the windows' sizes stay on the device until the end
    need_wh = torch.tensor(8, dtype=torch.int32, device=device)
    wc_need = torch.tensor(1, dtype=torch.int32, device=device)
    for c, cp in enumerate(cameras):
        for x0, iy, ix, valid in _exact_slabs(cp, grid, image_hw,
                                              cg * x_per_gx, device):
            so = x0 // x_per_gx * gy * gz
            sup_rows = slice(so, so + nsuper_c)
            blk_rows = slice(so * nsub, (so + nsuper_c) * nsub)
            iy_b, ix_b, valid_b = to_blocked(iy), to_blocked(ix), to_blocked(
                valid)
            pk[sup_rows, :, c] = _pk_words(
                torch.where(valid_b, iy_b, INVALID_ROW), ix_b)
            allv[sup_rows] &= valid_b.all(dim=2)
            any_v = valid_b.any(dim=2)
            ymin, ymax = _extent(iy_b, valid_b, any_v)
            xmin, xmax = _extent(ix_b, valid_b, any_v)
            v0 = (ymin // 8) * 8
            vorig[sup_rows, :, c] = v0
            need_wh = torch.maximum(need_wh, (ymax - v0).max() + 1)
            ry[c, blk_rows] = _spans(any_v, ymin, ymax, lanes_h)
            rx[c, blk_rows] = _spans(any_v, xmin, xmax, lanes_w)
            if c == color_camera:
                lcc[sup_rows] = torch.where(valid_b, ix_b, -1)
                u0 = (xmin // 64) * 64
                uorig[sup_rows, :, 0] = u0
                wc_need = torch.maximum(wc_need, (xmax - u0).max() + 1)
    WH = _ceil_to(int(need_wh), 8)
    WC = _ceil_to(int(wc_need), LANE)
    _spot_check(pk, perm, cameras, grid, image_hw)
    return BlockTables(
        grid_shape=grid.shape, sub_shape=tuple(sub), sup_shape=tuple(sup),
        nblocks=nblocks, nsuper=nsuper, nsub=nsub, num_cameras=C,
        image_hw=(H, W), Hp=_ceil_to(H, 8) + WH,
        n_words=_ceil_to(W, WORD_BITS) // WORD_BITS,
        Wc=_ceil_to(W, LANE) + WC, WH=WH, WC=WC, color_camera=color_camera,
        pk=pk, lcc=lcc, vorig=vorig, uorig=uorig,
        allv=allv.to(torch.int32), ry=ry, rx=rx, n_fcells_hw=(hf, wf),
        perm=perm,
    )


def _spot_check(pk, perm, cameras, grid, image_hw):
    """Re-project ``SPOT_CHECK_VOXELS`` voxels (seeded, as ``vbr_tpu`` draws
    them)
    in f64 on the host and compare their ``pk`` words; raises
    ``AssertionError`` at the first camera with a mismatch.  The device
    build's exactness rests on the suspicion bands, set for the rig's image
    scale and distortion; this guards rigs outside that envelope."""
    rng = np.random.default_rng(0)
    nsuper, nsub, _ = perm.shape
    M = min(SPOT_CHECK_VOXELS, grid.num_voxels)
    so, sb, sl = (rng.integers(0, n, M) for n in (nsuper, nsub, BV))
    gidx = perm[so, sb, sl]
    at = [torch.from_numpy(a).to(pk.device) for a in (so, sb, sl)]
    got = pk[at[0], at[1], :, at[2]].cpu().numpy()  # (M, C)
    axes = grid.axis_ranges()
    for c, cp in enumerate(cameras):
        iy, ix, valid = _exact_f64(cp, axes, gidx, image_hw)
        bad = np.flatnonzero(
            got[:, c] != _pk_words(np.where(valid, iy, INVALID_ROW), ix))
        if bad.size:
            raise AssertionError(
                f"device table build failed the f64 spot check: camera {c}, "
                f"{bad.size}/{M} sampled voxels differ (first at canonical "
                f"index {int(gidx[bad[0]])}); this rig is outside the "
                "suspicion bands' envelope: build with accelerate=False")


def tables_static_tuple(tables: BlockTables):
    """Hashable static geometry (same fields and order as the JAX one)."""
    return (
        tables.num_cameras, tables.nsuper, tables.nsub, tables.WH,
        tables.WC, tables.n_words, tables.color_camera, tables.sub_shape,
        tables.sup_shape, tables.nblocks, tables.Hp, tables.Wc,
    )


def block_activity(masks, views_threshold, allv, ry, rx):
    """(C, H, W) u8 masks → per-sub-block (active, full) i32 flags (nblk,).

    active = 0 only when fewer than ``views_threshold`` cameras have any
    foreground among the fine cells covering the block's projected bbox;
    full = 1 only when every covering cell is entirely foreground in every
    camera and every projection is valid (``allv``)."""
    C, H, W = masks.shape
    hf_p, wf_p = ry.shape[2], rx.shape[2]
    fg = torch.zeros((C, hf_p * FCELL, wf_p * FCELL), dtype=torch.float32,
                     device=masks.device)
    fg[:, :H, :W] = (masks > 0).to(torch.float32)
    cells = fg.reshape(C, hf_p, FCELL, wf_p, FCELL)
    fmax = cells.amax(dim=(2, 4))
    fmin = cells.amin(dim=(2, 4))

    def bilinear(M):  # out[c, b] = Σ_i Σ_j ry[c,b,i]·M[c,i,j]·rx[c,b,j]
        return (torch.bmm(ry, M) * rx).sum(dim=-1)

    cam_any = (bilinear(fmax) > 0).to(torch.int32)
    active = (cam_any.sum(dim=0) >= views_threshold).to(torch.int32)
    cam_full = (bilinear(1.0 - fmin) == 0).to(torch.int32)
    full = (cam_full.sum(dim=0) == C).to(torch.int32) * allv.reshape(-1)
    return active, full


def carve_blocked_kernel(pk, lcc, active, full, masks, image, *,
                         color_camera: int, views_threshold: int):
    """Kernel K1: blocked tables + flags + masks + colour frame →
    (occ_b (nsuper, nsub, BV) u8 0/1, col_b (nsuper, nsub, 3, BV) u8 BGR).

    CUDA tensors launch ``csrc/carve_blocked.cu`` (persistent CTAs, four
    voxels per thread: byte e of an output word is voxel 4v + e); CPU
    tensors run :func:`carve_blocked_plain`.  The kernel takes any number
    of cameras: the rig's C = 4 is compiled in and brings its tables
    through a ring in shared memory; another C reads them straight from
    device memory (:func:`k1_launch_plan` says which)."""
    if pk.device.type == "cpu":
        return carve_blocked_plain(pk, lcc, active, full, masks, image,
                                   color_camera=color_camera,
                                   views_threshold=views_threshold)
    if pk.device.type != "cuda":
        raise ValueError(f"no kernel for device {pk.device}")
    nsuper, nsub, C, _ = pk.shape
    H, W = masks.shape[1:]
    dev = pk.device
    nblk = nsuper * nsub
    check(pk, "pk", torch.int32, (nsuper, nsub, C, BV), dev)
    check(lcc, "lcc", torch.int32, (nsuper, nsub, BV), dev)
    check(active, "active", torch.int32, (nblk,), dev)
    check(full, "full", torch.int32, (nblk,), dev)
    check(masks, "masks", torch.uint8, (C, H, W), dev)
    check(image, "image", torch.uint8, (H, W, 3), dev)
    if not 0 <= color_camera < C:
        raise ValueError(f"color_camera {color_camera} out of range")
    for name, t in (("pk", pk), ("lcc", lcc)):
        if t.data_ptr() % 16:  # the kernel reads them as 16-byte words
            raise ValueError(f"{name} must be 16-byte aligned")
    occ = torch.empty((nsuper, nsub, BV), dtype=torch.uint8, device=dev)
    col = torch.empty((nsuper, nsub, 3, BV), dtype=torch.uint8, device=dev)
    K1.launch(ptr(pk), ptr(lcc), ptr(active), ptr(full), ptr(masks),
              ptr(image), ptr(occ), ptr(col), nblk, C, H, W,
              int(color_camera), int(views_threshold))
    return occ, col


_PLAN_KEYS = ("c_static", "shared_bytes_per_cta", "ctas_per_sm", "ctas")


def _launch_plan(kernel: CudaKernel, symbol: str, keys, *args: int) -> dict:
    """What a carve's ``*_plan`` entry point reports, by ``keys``; the
    ``*_static`` ones (C, or NF, fixed at compile time) are booleans, and
    ``route`` follows from C: ``"ring"`` (C compiled in, tables through
    shared memory) or ``"direct"`` (read from device memory)."""
    fn = kernel.function(symbol, [ctypes.c_int] * len(args)
                         + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * len(keys))()
    kernel.status_ok(fn(*args, out), symbol)
    plan = {k: bool(v) if k.endswith("_static") else v
            for k, v in zip(keys, out)}
    plan["route"] = "ring" if plan["c_static"] else "direct"
    return plan


def k1_launch_plan(nblk: int, C: int) -> dict:
    """What K1 launches for ``nblk`` sub-blocks and ``C`` cameras on the
    current CUDA device: whether C is fixed at compile time, shared bytes
    per CTA, CTAs per SM, CTAs (a grid that does not grow with nblk) and
    the route of the tables (``"ring"`` or ``"direct"``)."""
    return _launch_plan(K1, "vbr_carve_blocked_plan", _PLAN_KEYS, nblk, C)


def carve_blocked_plain(pk, lcc, active, full, masks, image, *,
                        color_camera: int, views_threshold: int):
    """Plain PyTorch version of K1 (any device; the wrapper uses it for
    CPU tensors only)."""
    nsuper, nsub, C, _ = pk.shape
    H, W = masks.shape[1:]
    row = pk >> 10
    x = ((pk >> 3) & 127) * WORD_BITS + (pk & 7)
    valid = row != INVALID_ROW
    lin = torch.where(valid, row * W + x, 0).long()
    fg = masks.reshape(C, -1) > 0
    count = torch.zeros((nsuper, nsub, BV), dtype=torch.int32,
                        device=pk.device)
    for c in range(C):
        count += (valid[:, :, c] & fg[c][lin[:, :, c]]).to(torch.int32)
    act = active.reshape(nsuper, nsub, 1) > 0
    is_full = full.reshape(nsuper, nsub, 1) > 0
    count = torch.where(is_full, C, torch.where(act, count, 0))
    occ = act & (count >= views_threshold)
    row_c = row[:, :, color_camera]
    ok = occ & (row_c != INVALID_ROW) & (lcc >= 0)
    lin_c = torch.where(ok, row_c * W + lcc, 0).long()
    col = image.reshape(-1, 3)[lin_c]  # (nsuper, nsub, BV, 3)
    col = torch.where(ok[..., None], col, 0).to(torch.uint8)
    return occ.to(torch.uint8), col.permute(0, 1, 3, 2).contiguous()


def _blocked_to_canonical(x_blocked, sub, sup, nblocks, lead=0):
    """(*L, nsuper, nsub·BV, *t) blocked → (*L, N, *t) canonical C-order,
    the ``lead`` axes L kept in front (one copy, row-major)."""
    gx, gy, gz = nblocks
    spx, spy, spz = sup
    sbx, sby, sbz = sub
    head = tuple(x_blocked.shape[:lead])
    trailing = tuple(x_blocked.shape[lead + 2:])
    x = x_blocked.reshape(head + (gx, gy, gz, spx, spy, spz, sbx, sby, sbz)
                          + trailing)
    fwd = (0, 3, 6, 1, 4, 7, 2, 5, 8)
    inv = (list(range(lead)) + [lead + fwd.index(k) for k in range(9)]
           + list(range(lead + 9, lead + 9 + len(trailing))))
    n = x_blocked.shape[lead] * x_blocked.shape[lead + 1]
    return x.permute(inv).reshape(head + (n,) + trailing)


def carve_blocked(masks: torch.Tensor, image: torch.Tensor,
                  tables: BlockTables, *, views_threshold: int = 4,
                  layout: str = "canonical"):
    """Full-frame carve: (C, H, W) u8 masks + (H, W, 3) u8 BGR colour-camera
    frame → occupancy and colours.

    ``layout="canonical"``: (occ (N,) bool, colors (N, 3) u8) in
    ``GridConfig.voxel_points()`` order.  ``layout="blocked"``: (occ_b
    (nsuper, nsub, BV) u8, col_b (nsuper, nsub, 3, BV) u8), for
    :func:`compact_voxels_blocked`.  Colours are 0 off the hull."""
    if layout not in ("canonical", "blocked"):
        raise ValueError(f"unknown layout {layout!r}")
    active, full = block_activity(masks, views_threshold, tables.allv,
                                  tables.ry, tables.rx)
    occ_b, col_b = carve_blocked_kernel(
        tables.pk, tables.lcc, active, full, masks.contiguous(),
        image.contiguous(), color_camera=tables.color_camera,
        views_threshold=views_threshold,
    )
    if layout == "blocked":
        return occ_b, col_b
    nsuper, nsub = tables.nsuper, tables.nsub
    occ = _blocked_to_canonical(occ_b.reshape(nsuper, nsub * BV),
                                tables.sub_shape, tables.sup_shape,
                                tables.nblocks)
    col_v = col_b.permute(0, 1, 3, 2).reshape(nsuper, nsub * BV, 3)
    colors = _blocked_to_canonical(col_v, tables.sub_shape, tables.sup_shape,
                                   tables.nblocks)
    return occ.bool(), colors


# ---------------------------------------------------------------------------
# Offline multi-frame carve (kernel K4)
# ---------------------------------------------------------------------------


def carve_frames_kernel(pk, active, full, masks, *, views_threshold: int):
    """Kernel K4: blocked tables + chunk-wide flags + (NF, C, H, W) u8 masks
    → occupancy (NF, nsuper, nsub, BV) u8 0/1, frame-major.

    CUDA tensors launch ``csrc/carve_frames.cu`` (persistent CTAs, four
    voxels per thread: byte e of a frame's output word is voxel 4v + e);
    CPU tensors run :func:`carve_frames_plain`.  The kernel takes any
    number of cameras and frames: the rig's C = 4 is compiled in (and NF
    = 8, the offline chunk) and runs with packed byte counters and its
    tables through a ring in shared memory; another C reads the tables
    straight from device memory and counts in 32-bit integers
    (:func:`k4_launch_plan` says which)."""
    if pk.device.type == "cpu":
        return carve_frames_plain(pk, active, full, masks,
                                  views_threshold=views_threshold)
    if pk.device.type != "cuda":
        raise ValueError(f"no kernel for device {pk.device}")
    nsuper, nsub, C, _ = pk.shape
    NF, _, H, W = masks.shape
    dev = pk.device
    nblk = nsuper * nsub
    check(pk, "pk", torch.int32, (nsuper, nsub, C, BV), dev)
    check(active, "active", torch.int32, (nblk,), dev)
    check(full, "full", torch.int32, (nblk,), dev)
    check(masks, "masks", torch.uint8, (NF, C, H, W), dev)
    occ = torch.empty((NF, nsuper, nsub, BV), dtype=torch.uint8, device=dev)
    for name, t in (("pk", pk), ("occ", occ)):
        if t.data_ptr() % 16:  # 16-byte copies and stores
            raise ValueError(f"{name} must be 16-byte aligned")
    K4.launch(ptr(pk), ptr(active), ptr(full), ptr(masks), ptr(occ), nblk,
              NF, C, H, W, int(views_threshold))
    return occ


def k4_launch_plan(nblk: int, C: int, NF: int) -> dict:
    """What K4 launches for ``nblk`` sub-blocks, ``C`` cameras and ``NF``
    frames on the current CUDA device, as :func:`k1_launch_plan` reports
    it for K1, and whether NF is fixed at compile time."""
    return _launch_plan(K4, "vbr_carve_frames_plan",
                        _PLAN_KEYS + ("nf_static",), nblk, C, NF)


def carve_frames_plain(pk, active, full, masks, *, views_threshold: int):
    """Plain PyTorch version of K4 (any device; the wrapper uses it for
    CPU tensors only)."""
    nsuper, nsub, C, _ = pk.shape
    NF, _, H, W = masks.shape
    row = pk >> 10
    x = ((pk >> 3) & 127) * WORD_BITS + (pk & 7)
    valid = row != INVALID_ROW
    lin = torch.where(valid, row * W + x, 0).long()
    fg = masks.reshape(NF, C, -1) > 0
    count = torch.zeros((NF, nsuper, nsub, BV), dtype=torch.int32,
                        device=pk.device)
    for c in range(C):
        count += (valid[:, :, c] & fg[:, c][:, lin[:, :, c]]).to(torch.int32)
    act = active.reshape(nsuper, nsub, 1) > 0
    is_full = full.reshape(nsuper, nsub, 1) > 0
    count = torch.where(is_full, C, count)
    return (act & (count >= views_threshold)).to(torch.uint8)


def chunk_activity(masks: torch.Tensor, tables: BlockTables,
                   views_threshold: int):
    """K4's flags for a chunk of (NF, C, H, W) u8 masks: a block is active
    when the UNION of the frames' foreground could reach the view threshold
    in its footprint, and full only when their INTERSECTION is entirely
    foreground (then every frame's count is C for every voxel)."""
    active, _ = block_activity(masks.amax(dim=0), views_threshold,
                               tables.allv, tables.ry, tables.rx)
    _, full = block_activity(masks.amin(dim=0), views_threshold,
                             tables.allv, tables.ry, tables.rx)
    return active, full


def _carve_frames_device(masks: torch.Tensor, tables: BlockTables, *,
                         views_threshold: int) -> torch.Tensor:
    """One launch over a chunk: (NF, C, H, W) u8 masks → (NF, N) bool
    canonical occupancy, row-major (a frame's voxels contiguous, so a
    frame's row downloads as one block), with the flags of
    :func:`chunk_activity`."""
    NF = masks.shape[0]
    active, full = chunk_activity(masks, tables, views_threshold)
    occ_b = carve_frames_kernel(tables.pk, active, full, masks.contiguous(),
                                views_threshold=views_threshold)
    nsuper, nsub = tables.nsuper, tables.nsub
    occ = _blocked_to_canonical(occ_b.reshape(NF, nsuper, nsub * BV),
                                tables.sub_shape, tables.sup_shape,
                                tables.nblocks, lead=1)
    return occ.bool()


def carve_frames_blocked(masks: torch.Tensor, tables: BlockTables, *,
                         views_threshold: int = 4,
                         frames_per_launch: int = 8) -> torch.Tensor:
    """Offline multi-frame carve: (F, C, H, W) u8 masks → canonical
    per-frame occupancy (F, N) bool, each frame equal to
    ``carve.carve_from_tables``.  ``frames_per_launch`` frames go through
    one launch; the last chunk is padded with all-background frames, whose
    outputs are dropped.  Colours are not computed here: a chunked caller
    that holds its frames on the device gathers the occupied voxels'
    colours there (:func:`chunk_colors_device`), one that holds them on the
    host gathers them frame by frame (:func:`frame_colors_host`)."""
    F = masks.shape[0]
    NF = int(frames_per_launch)
    pad = (-F) % NF
    if pad:
        masks = torch.cat([masks, masks.new_zeros((pad,) + masks.shape[1:])])
    occ_chunks = [
        _carve_frames_device(masks[start:start + NF], tables,
                             views_threshold=views_threshold)
        for start in range(0, F + pad, NF)
    ]
    return torch.cat(occ_chunks)[:F]


def chunk_colors_device(occ: torch.Tensor, frames: torch.Tensor,
                        lin_idx: torch.Tensor, color_camera: int = 1):
    """Colour gather at a chunk's occupied voxels on the chunk's device:
    canonical ``occ`` (NF, N) bool, the chunk's frames (NF, C, H, W, 3) u8
    and the table path's ``lin_idx`` (C, N) → (counts (NF,) i64, idx (M,)
    i64, col (M, 3) u8 BGR), the M occupied voxels frame by frame in
    ascending order: frame f's are ``idx[a:b]``, ``col[a:b]`` with ``b - a
    = counts[f]``, each equal to :func:`frame_colors_host` on that frame.
    One ``nonzero`` over the chunk, so one host sync on a card."""
    NF, N = occ.shape
    flat = occ.reshape(-1).nonzero().squeeze(1)
    frame = flat // N
    idx = flat - frame * N
    H, W = frames.shape[2:4]
    image = frames.select(1, color_camera).reshape(NF, H * W, 3)
    col = image[frame, lin_idx[color_camera][idx].long()]
    return occ.sum(dim=1), idx, col


def frame_colors_host(occ: np.ndarray, image: np.ndarray,
                      lin_idx: np.ndarray, color_camera: int = 1):
    """Host colour gather at one frame's occupied voxels: canonical ``occ``
    (N,) bool, the colour camera's (H, W, 3) u8 frame and the table path's
    ``lin_idx`` (C, N) → (idx (M,), col (M, 3))."""
    idx = np.flatnonzero(to_host(occ))
    li = to_host(lin_idx[color_camera])[idx]
    return idx, to_host(image).reshape(-1, 3)[li]


def canonicalize_host(x_blocked, tables: BlockTables) -> np.ndarray:
    """Blocked (nsuper, nsub, BV[, t]) → canonical (N[, t]) on the host."""
    x = to_host(x_blocked)
    flat = x.reshape((tables.nsuper * tables.nsub * BV,) + x.shape[3:])
    out = np.empty_like(flat)
    out[tables.perm.ravel()] = flat
    return out


def compact_voxels_blocked(occ_blocked, colors_blocked, tables: BlockTables,
                           grid: GridConfig, scaling_factor: float = 64.0):
    """Viewer compaction straight from the blocked layout (rows in blocked
    order): truncated positions with the (x, -z, y)/scale swap and RGB
    colours in [0, 1], as float32 numpy."""
    occ = to_host(occ_blocked).ravel().astype(bool)
    col = np.moveaxis(to_host(colors_blocked), 2, 3).reshape(-1, 3)
    pts = grid.voxel_points()[tables.perm.ravel()]
    return viewer_arrays(pts[occ], col[occ], scaling_factor)


WIRE_K_BLOCKS = 512  # sub-blocks with any occupied voxel (rig: ~263)
WIRE_K_VOXELS = 98304  # occupied-voxel colour slots (rig: ~57k)


def pack_blocked_outputs(occ_b: torch.Tensor, col_b: torch.Tensor,
                         k_blocks: int = None, k_voxels: int = None):
    """The viewer wire's compression of blocked carve outputs, on their
    device with no wait for the host.

    Occupancy → the bitmaps (8 voxels a byte, little-endian) of the first
    ``k_blocks`` sub-blocks that hold an occupied voxel, with their ids;
    colours → the occupied voxels' BGR in ascending blocked order (the
    bitmaps' bit order, so the decoder needs no voxel index), ``k_voxels``
    rows.  Past the counts, ``ids`` repeat the last sub-block (a clipped
    ``searchsorted``) and colour rows repeat voxel 0's (zero past the
    grid), as in the JAX package.  Both capacities default to the module's
    ``WIRE_K_BLOCKS`` and ``WIRE_K_VOXELS``, read at the call.

    Returns ``(packed_k (k_blocks, BV/8) u8, ids (k_blocks,) i32, n_blocks
    () i32, n_vox () i32, cols (k_voxels, 3) u8, overflow () bool)``;
    ``overflow`` says that a count exceeds its capacity, and the caller
    then takes the uncompressed outputs."""
    k_blocks = WIRE_K_BLOCKS if k_blocks is None else k_blocks
    k_voxels = WIRE_K_VOXELS if k_voxels is None else k_voxels
    nsuper, nsub, BVv = occ_b.shape
    dev = occ_b.device
    nblk = nsuper * nsub
    occ_u = (occ_b > 0).to(torch.uint8).reshape(nblk, BVv)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    packed = (occ_u.reshape(nblk, BVv // 8, 8) << shifts).sum(
        -1, dtype=torch.uint8)
    cs = torch.cumsum(occ_u.amax(1), 0, dtype=torch.int32)
    n_blocks = cs[-1]
    pos = torch.searchsorted(cs, torch.arange(1, k_blocks + 1,
                                              dtype=torch.int32, device=dev))
    ids = pos.clamp(0, nblk - 1).to(torch.int32)
    packed_k = packed[ids.long()]

    total = nblk * BVv
    kv = min(k_voxels, total)
    nblk128 = -(-total // mc._COMPACT_BLOCK)
    vidx, n_vox = mc._compact_active(occ_u.reshape(-1) > 0, kv,
                                     min(nblk128, kv))
    vidx = vidx.long()
    # colour c of voxel v sits at (v // BV)·3·BV + c·BV + v % BV
    base = (vidx // BVv) * (3 * BVv) + vidx % BVv
    chan = torch.arange(3, device=dev) * BVv
    cols = col_b.reshape(-1)[base[:, None] + chan]  # (kv, 3) BGR
    if kv < k_voxels:
        cols = torch.cat([cols, cols.new_zeros((k_voxels - kv, 3))])
    ovf = (n_blocks > k_blocks) | (n_vox > kv)
    return packed_k, ids, n_blocks, n_vox, cols, ovf


def encode_wire(packed_k, ids, n_blocks, n_vox, cols, any_ovf):
    """One u8 buffer ``[any_ovf, n_blocks, n_vox i32][ids i32·k_blocks]
    [packed_k][cols]``, integers little-endian: one download a frame."""
    head = torch.stack([any_ovf.to(torch.int32), n_blocks.to(torch.int32),
                        n_vox.to(torch.int32)]).view(torch.uint8)
    return torch.cat([head, ids.to(torch.int32).view(torch.uint8),
                      packed_k.reshape(-1), cols.reshape(-1)])


def decode_wire(wire_host, k_blocks: int = None, k_voxels: int = None,
                total_voxels: int = None):
    """Host inverse of :func:`encode_wire` → (any_ovf, n_blocks, n_vox,
    ids, packed_k, cols) numpy views.  ``total_voxels`` (the grid's voxel
    count) clamps ``k_voxels`` as the encoder does on small grids."""
    k_blocks = WIRE_K_BLOCKS if k_blocks is None else k_blocks
    k_voxels = WIRE_K_VOXELS if k_voxels is None else k_voxels
    if total_voxels is not None:
        k_voxels = min(k_voxels, total_voxels)
    buf = to_host(wire_host)
    any_ovf, n_blocks, n_vox = np.frombuffer(buf[:12].tobytes(), np.int32)
    o = 12
    ids = np.frombuffer(buf[o:o + 4 * k_blocks].tobytes(), np.int32)
    o += 4 * k_blocks
    nb = k_blocks * (BV // 8)
    packed_k = buf[o:o + nb].reshape(k_blocks, BV // 8)
    o += nb
    cols = buf[o:o + k_voxels * 3].reshape(k_voxels, 3)
    return int(any_ovf), int(n_blocks), int(n_vox), ids, packed_k, cols


def viewer_arrays_from_packed(packed_k, ids, n_blocks, n_vox, cols,
                              tables: BlockTables, grid: GridConfig,
                              scaling_factor: float = 64.0):
    """Host unpack of :func:`pack_blocked_outputs` into the viewer contract:
    the same rows as :func:`compact_voxels_blocked` (blocked order)."""
    packed_k, ids, cols = to_host(packed_k), to_host(ids), to_host(cols)
    n_blocks, n_vox = int(n_blocks), int(n_vox)
    bits = np.unpackbits(packed_k[:n_blocks].reshape(-1),
                         bitorder="little").astype(bool)
    vox = (ids[:n_blocks, None].astype(np.int64) * BV
           + np.arange(BV, dtype=np.int64)[None, :]).reshape(-1)[bits]
    if len(vox) != n_vox:
        raise ValueError(f"corrupt wire: {len(vox)} voxels in the bitmaps, "
                         f"{n_vox} colours")
    pts = _blocked_points_cache(grid, tables.sub_shape, tables.sup_shape)
    return viewer_arrays(pts[vox], cols[:n_vox], scaling_factor)


@functools.lru_cache(maxsize=4)
def _blocked_points_cache(grid: GridConfig, sub_shape, sup_shape):
    """The grid's voxel points in blocked order, truncated and in f32
    (integer mm at the reference's grid steps, so exact): what
    :func:`viewer_arrays_from_packed` gathers from every frame."""
    perm, _ = _blocked_permutation(grid.shape, sub_shape, sup_shape)
    return np.trunc(grid.voxel_points()[perm.ravel()]).astype(np.float32)
