"""The production step over the (data, cam, grid) mesh: kernels K2 and K1
on every rank.

Counterpart of ``vbr_tpu/parallel/pallas_sharded.py``.  Each rank runs the
fused per-frame program of ``models.visual_hull._full_step`` on its shard:

  * ``data`` — the rank's frames of the batch,
  * ``cam``  — the mask stage of the rank's cameras
    (``background.MaskStage``: HSV, the compressed frozen MOG apply,
    pre-morphology, the cleanup (kernel K2 on the rank's C/cam images)
    and post-morphology),
  * ``grid`` — the carve (kernel K1) of the rank's superblocks, which are
    split over ``("cam", "grid")`` jointly: shard k = c·grid + g.

One ``all_gather`` over ``cam`` brings every camera's masks and frames to
every rank (0.3 MB of masks at the rig, where per-camera partial counts
would be 8.4 MB per shard), and the carve runs with all C cameras on the
rank's slice of the blocked tables.

Placement.  The superblocks are padded to a multiple of the shard count
with inert rows (``allv`` 0, zero activity spans, colour column −1,
``perm`` −1), which K1 skips and writes as zeros.  Every per-superblock
table and ``perm`` are gathered by one permutation, so any order of the
superblocks is exact; :func:`superblock_order` gives ``"contiguous"``,
``"strided"`` (the mask-free default) and ``"cost"`` (capacity-bounded LPT
over :func:`superblock_costs` of a representative frame).  The port's
``BlockTables`` keep ``ry``/``rx`` as f32 (C, nsuper·nsub, ·), so a
superblock permutation gathers groups of ``nsub`` rows on their axis 1
(on axis 0 of the others).  :func:`local_table_slice` cuts one shard's
slice without building the padded whole (the 512³ × 8 tables are ~9 GB).

Morphology flags.  Each rank is its own program, so its cameras' flags
are static branches (JAX's single SPMD program selects with ``jnp.where``;
both give the same bits).  ``mask_flags_array`` stays as the placement's
format.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vbr_tpu_torch.ops import carve_blocked, gmm
from vbr_tpu_torch.ops.carve_blocked import BlockTables
from vbr_tpu_torch.parallel.carve_sharded import (all_gather_dim, axis_size,
                                                  local_block, rank_device)
from vbr_tpu_torch.pipelines import background
from vbr_tpu_torch.utils.config import MaskParams


@dataclasses.dataclass(frozen=True)
class ShardedTables:
    """This rank's slice of the padded, ordered block tables."""

    tables: BlockTables  # nsuper = superblocks per shard, on the rank
    nsuper_pad: int
    # superblock→slot permutation of the placement (None = contiguous)
    order: Optional[np.ndarray] = None


def mask_flags_array(mask_params) -> np.ndarray:
    """Per-camera morphology flags as a (C, 4) bool array
    (opening_pre, closing_pre, opening_post, closing_post)."""
    return np.asarray(
        [(p.opening_pre, p.closing_pre, p.opening_post, p.closing_post)
         for p in mask_params],
        dtype=bool,
    )


def _flag_params(flags):
    """(c, 4) flags → per-camera ``MaskParams`` carrying them (the mask
    stage takes its thresholds apart and reads only the flags here)."""
    return tuple(MaskParams(opening_pre=bool(f[0]), closing_pre=bool(f[1]),
                            opening_post=bool(f[2]), closing_post=bool(f[3]))
                 for f in np.asarray(flags, bool))


def shard_count(mesh: DeviceMesh) -> int:
    """Superblock shards of the mesh: cam × grid."""
    return axis_size(mesh, "cam") * axis_size(mesh, "grid")


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's superblock shard, c·grid + g."""
    return (mesh.get_local_rank("cam") * axis_size(mesh, "grid")
            + mesh.get_local_rank("grid"))


def superblock_order(nsuper: int, nshards: int, mode: str = "strided",
                     costs=None) -> np.ndarray:
    """Superblock→shard-slot permutation over the PADDED block count.

    Returns an int64 array of length ``nsuper_pad`` (``nsuper`` rounded up
    to a multiple of ``nshards``); slot ``j`` holds padded superblock id
    ``order[j]`` (ids ≥ ``nsuper`` are the inert pad), and shard ``k``'s
    slice is the contiguous ``order[k·nloc:(k+1)·nloc]``.

    Modes: ``"contiguous"`` (identity, z-major slabs), ``"strided"`` (shard
    k gets ids ``k, k+S, k+2S, …``: balanced without masks), ``"cost"``
    (capacity-bounded longest-processing-time greedy over ``costs``, one
    nonnegative cost per superblock, e.g. :func:`superblock_costs`; pad ids
    cost 0).
    """
    pad = (-nsuper) % nshards
    npd = nsuper + pad
    nloc = npd // nshards
    if mode == "contiguous":
        return np.arange(npd, dtype=np.int64)
    if mode == "strided":
        return np.arange(npd, dtype=np.int64).reshape(nloc, nshards).T.ravel()
    if mode != "cost":
        raise ValueError(f"unknown superblock order mode {mode!r}")
    if costs is None or len(costs) != nsuper:
        raise ValueError("mode='cost' needs one cost per superblock")
    c = np.zeros(npd, np.float64)
    c[:nsuper] = np.asarray(costs, np.float64)
    if (c < 0).any():
        raise ValueError("costs must be nonnegative")
    bins = [[] for _ in range(nshards)]
    totals = np.zeros(nshards, np.float64)
    for i in np.argsort(-c, kind="stable"):
        open_ = np.array([len(b) < nloc for b in bins])
        k = int(np.argmin(np.where(open_, totals, np.inf)))
        bins[k].append(int(i))
        totals[k] += c[i]
    return np.concatenate([np.asarray(b, np.int64) for b in bins])


def superblock_costs(tables: BlockTables, masks,
                     views_threshold: int) -> np.ndarray:
    """(nsuper,) per-superblock carve-cost estimate for ``mode="cost"``,
    from K1's own activity flags (``carve_blocked.block_activity``) on a
    representative frame's (C, H, W) u8 masks: a counted sub-block costs 1,
    a full one 0.25 (colours only), an inactive one ~0, and every
    superblock 0.02 of dispatch."""
    masks = (masks if isinstance(masks, torch.Tensor)
             else torch.tensor(np.asarray(masks)))
    active, full = carve_blocked.block_activity(
        masks.to(tables.pk.device), views_threshold, tables.allv, tables.ry,
        tables.rx)
    a = active.cpu().numpy().reshape(tables.nsuper, tables.nsub)
    f = full.cpu().numpy().reshape(tables.nsuper, tables.nsub)
    return ((a * (1 - f)).sum(axis=1) + 0.25 * (a * f).sum(axis=1)
            + 0.02).astype(np.float64)


def _padded_gather(tables: BlockTables, nshards: int,
                   order: Optional[np.ndarray], lo: int = 0, hi=None):
    """Slot rows ``[lo:hi)`` of every per-superblock table as if it were
    padded to the shard multiple and permuted by ``order`` (slot j ← padded
    id ``order[j]``; ids ≥ nsuper are inert pad rows), on the tables'
    device, without building the padded whole.  Returns (dict of tensors,
    and ``perm`` numpy, nsuper_pad)."""
    nsuper, nsub = tables.nsuper, tables.nsub
    npd = nsuper + (-nsuper) % nshards
    if order is None:
        order = np.arange(npd, dtype=np.int64)
    order = np.asarray(order)
    if len(order) != npd or not np.array_equal(np.sort(order),
                                               np.arange(npd)):
        raise ValueError(
            f"order must be a permutation of range({npd}) "
            "(padded superblock count)")
    ids = order[lo:npd if hi is None else hi]
    is_pad = ids >= nsuper
    safe = np.where(is_pad, 0, ids)
    dev = tables.pk.device
    safe_t = torch.from_numpy(safe).to(dev)
    pad_t = torch.from_numpy(is_pad).to(dev)

    def take0(x, fill=0):
        out = x[safe_t]
        if is_pad.any():
            out[pad_t] = fill
        return out

    def take1(x):  # (C, nblk, L), nblk superblock-major: whole superblocks
        C, _, L = x.shape
        out = x.reshape(C, nsuper, nsub, L)[:, safe_t]
        if is_pad.any():
            out[:, pad_t] = 0
        return out.reshape(C, len(ids) * nsub, L)

    out = {
        "pk": take0(tables.pk),
        "lcc": take0(tables.lcc, fill=-1),  # pad: no valid colour column
        "vorig": take0(tables.vorig),
        "uorig": take0(tables.uorig),
        "allv": take0(tables.allv),
        "ry": take1(tables.ry),
        "rx": take1(tables.rx),
    }
    perm = None
    if tables.perm is not None:
        # pad rows get the -1 sentinel: a pad block has no canonical voxel,
        # and 0 would alias voxel 0 under a scatter by perm
        perm = np.asarray(tables.perm)[safe]
        if is_pad.any():
            perm[is_pad] = -1
    return out, perm, npd


def local_table_slice(tables: BlockTables, shard: int, nshards: int,
                      order: Optional[np.ndarray] = None) -> BlockTables:
    """Shard ``shard``'s padded superblock slice as standalone
    ``BlockTables`` (``nsuper`` = superblocks per shard), on the tables'
    device.

    It is exactly the table operand of that shard's local program in
    :func:`sharded_production_step` placed with the same ``order``: a
    blocked carve on it measures one shard's carve on one device (all
    the sharded step adds is the mask gather).  Blocked layout only:
    ``perm`` covers the slice, and its pad rows are −1."""
    npd = tables.nsuper + (-tables.nsuper) % nshards
    nloc = npd // nshards
    g, perm, _ = _padded_gather(tables, nshards, order, shard * nloc,
                                (shard + 1) * nloc)
    return dataclasses.replace(tables, nsuper=nloc, perm=perm, **g)


def shard_block_tables(mesh: DeviceMesh, tables: BlockTables,
                       order: Optional[np.ndarray] = None) -> ShardedTables:
    """This rank's slice of the tables padded to the shard count and
    placed in superblock ``order`` (:func:`superblock_order`; None =
    contiguous), on the rank's device."""
    S = shard_count(mesh)
    local = local_table_slice(tables, shard_index(mesh), S, order)
    dev = rank_device(mesh)
    if local.pk.device != dev:
        local = dataclasses.replace(local, **{
            f: getattr(local, f).to(dev)
            for f in ("pk", "lcc", "vorig", "uorig", "allv", "ry", "rx")})
    npd = tables.nsuper + (-tables.nsuper) % S
    return ShardedTables(tables=local, nsuper_pad=npd,
                         order=None if order is None else np.asarray(order))


def sharded_production_step(mesh: DeviceMesh, *, use_hsv: bool = True,
                            views_threshold: int = 4):
    """The sharded fused step:

        step(frames (f, c, H, W, 3) u8,
             fz_mean (c, H, W, Ke, 3) f32, fz_thr (c, H, W, Ke) f32,
             fz_bcount (c, H, W) i32, fig_thr, inner_thr (c floats),
             morph (c, 4) bool,            this rank's blocks
             tables                        ShardedTables.tables)
          -> (occ_b (F, nsuper_pad, nsub, BV) u8,
              col_b (F, nsuper_pad, nsub, 3, BV) u8,
              overflow (F, C) bool)        on every rank, slot order

    (see :func:`place_production_inputs`, :func:`shard_block_tables` and
    :func:`unshuffle_blocked`).  Per frame: the mask stage of the rank's
    cameras (kernel K2 on its c images), one ``all_gather`` of masks and
    frames over ``cam``, then K1 on the rank's superblocks with all C
    cameras; the outputs are gathered over ``grid``, ``cam`` (shard
    c·grid + g) and ``data``.  Bit-identical to ``process_frame_fast(
    layout="blocked")`` per frame; ``overflow[f, c]`` keeps the host
    cleanup redo contract of the single-device path."""

    def step(frames, fz_mean, fz_thr, fz_bcount, fig_thr, inner_thr, morph,
             tables):
        stage = background.MaskStage(
            gmm.FrozenMOGState(mean=fz_mean, thr=fz_thr, bcount=fz_bcount),
            _flag_params(morph), use_hsv, fig_thr, inner_thr)
        occ_out, col_out, ovf_out = [], [], []
        for fr in frames:
            masks, ovf, _ = stage(fr)
            masks_all = all_gather_dim(masks, mesh, "cam")  # (C, H, W)
            frames_all = all_gather_dim(fr, mesh, "cam")  # (C, H, W, 3)
            occ_b, col_b = carve_blocked.carve_blocked(
                masks_all, frames_all[tables.color_camera], tables,
                views_threshold=views_threshold, layout="blocked")
            occ_out.append(occ_b)
            col_out.append(col_b)
            ovf_out.append(ovf.to(torch.uint8))
        occ_b, col_b = (
            all_gather_dim(all_gather_dim(
                all_gather_dim(torch.stack(x), mesh, "grid", 1), mesh, "cam",
                1), mesh, "data")
            for x in (occ_out, col_out))
        ovf = all_gather_dim(all_gather_dim(torch.stack(ovf_out), mesh,
                                            "cam", 1), mesh, "data")
        return occ_b, col_b, ovf.bool()

    return step


def place_static_inputs(mesh: DeviceMesh, stacked_fz: gmm.FrozenMOGState,
                        fig_thr, inner_thr, morph_flags):
    """This rank's cameras' share of the inputs that never change between
    batches (the frozen MOG state on its device; thresholds as f32 values
    and morphology flags on the host).  Place them ONCE per runner: the
    compressed state is tens of MB."""
    dev = rank_device(mesh)
    cam = ("cam",)
    host = torch.device("cpu")

    def floats(t):
        return tuple(local_block(torch.tensor(t, dtype=torch.float32), mesh,
                                 cam, host).tolist())

    return (
        local_block(stacked_fz.mean, mesh, cam, dev),
        local_block(stacked_fz.thr, mesh, cam, dev),
        local_block(stacked_fz.bcount, mesh, cam, dev),
        floats(fig_thr),
        floats(inner_thr),
        local_block(torch.from_numpy(np.asarray(morph_flags, bool)), mesh,
                    cam, host).numpy(),
    )


def place_frames(mesh: DeviceMesh, frames) -> torch.Tensor:
    """This rank's block of one (F, C, H, W, 3) u8 frame batch (the only
    per-call input) on its device, over (data, cam); host arrays are
    uploaded through pinned memory without waiting."""
    return local_block(frames, mesh, ("data", "cam"), rank_device(mesh))


def place_production_inputs(mesh: DeviceMesh, frames, stacked_fz,
                            fig_thr, inner_thr, morph_flags):
    """All the step's inputs but the tables (one-shot convenience; a
    steady-state caller places :func:`place_static_inputs` once)."""
    return (place_frames(mesh, frames),) + place_static_inputs(
        mesh, stacked_fz, fig_thr, inner_thr, morph_flags)


def unpad_blocked(occ_b, col_b, tables: BlockTables):
    """Drop the shard-count padding: (F, nsuper_pad, ...) → (F, nsuper,
    ...).  Contiguous (order=None) placements only; with an ``order`` the
    pad slots are interleaved: use :func:`unshuffle_blocked`."""
    return occ_b[:, : tables.nsuper], col_b[:, : tables.nsuper]


def unshuffle_blocked(occ_b, col_b, tables: BlockTables,
                      order: Optional[np.ndarray]):
    """Invert the superblock ``order`` on blocked outputs (numpy or
    tensors) and drop the pad: slot j holds padded superblock ``order[j]``,
    so canonical position i is slot ``argsort(order)[i]``.  (F,
    nsuper_pad, ...) → (F, nsuper, ...) in the tables' canonical blocked
    order."""
    if order is None:
        return unpad_blocked(occ_b, col_b, tables)
    inv = np.argsort(np.asarray(order))[: tables.nsuper]
    if isinstance(occ_b, torch.Tensor):
        inv = torch.from_numpy(inv).to(occ_b.device)
    return occ_b[:, inv], col_b[:, inv]
