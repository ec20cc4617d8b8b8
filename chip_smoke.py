#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vbr_tpu_torch/csrc`` (into
``build/kernels``), then at the production rig size (128³ grid, 4 cameras
of 486×644, synthetic rig and a seeded 50-mixture background model):

  1. prints the card (``nvidia-smi`` name and power limit);
  2. builds the kernels and prints the build time and ptxas usage;
  3. K1 (blocked carve) against its plain PyTorch version on the card:
     outputs bit-equal, times, active fraction and bound, what it launches;
     then, bit-equal again and not timed, inputs the production frame does
     not reach: all masks empty, all masks full, a view threshold of 3,
     random masks, and on a 32^3 grid another colour camera and a rig of 3
     cameras; the kernel is run several times on each;
  4. K2 (combined-phase labelling) against its plain version on the raw
     masks of the main-path frame: labels bit-equal, iterations, times;
     then, labels and iteration counts bit-equal again, on inputs that
     reach what that frame does not: a serpentine corridor cut short by the
     ``max_iters`` cap and the same corridor run to its fixpoint, the
     corridor turned upright (labels travel along the columns, through the
     carry fold across the bands, for many iterations), a dense random
     image, an image in which the two column sweeps of one iteration meet
     inside every band, a checkerboard, components that cross every band seam of
     the cluster route, a batch of 32 images with differing iteration
     counts, a shape too large for the cluster route and a small one; the
     kernel is run several times on each; the route each took;
  5. the main path, ``VisualHull.process_frame_fast``, on the card and on
     the CPU: occupancy and colours bit-equal; the launch counters of K1
     and K2 advance;
  6. ``VisualHull.stream`` over 16 frames of a moving sphere: per-frame
     times, launches per kernel;
  7. a frame whose speckle overflows the device component table: the
     overflow bit is set and the exact host redo matches the CPU run;
  8. a ``torch.profiler`` trace of the main path: device time by kernel
     and the device's idle share;
  9. K3 (multi-frame MOG training) against its plain version on the card:
     one camera, one 16-frame chunk from a mid-training state, all four
     state arrays and the carried high-water mark bit-equal, times (also by
     the number of slots cached in shared memory) and bound; then,
     bit-equal again and not timed: random frames that drive pixels past
     the cached slots, the same with 1 and 2 cached slots, K = 3 and K = 1,
     a 37x53 image, a single frame, two chunks in a row, a state handed
     over without its mark; the kernel is run several times on each;
 10. training end to end, ``VisualHull.train_background`` on 32 seeded
     background frames per camera: K3 launches counted, a band of rows of
     one camera retrained by the plain version on the CPU, bit-equal;
 11. K4 (multi-frame carve) against its plain version on 8 frames of the
     moving sphere: occupancy bit-equal, times, bound, active fraction,
     what it launches; then, bit-equal again and not timed, inputs the
     production chunk does not reach: all masks empty, all full, random
     masks, a view threshold of 3, a chunk full in one frame only, chunks
     of 1, 5, 9 and 16 frames, and on a 32^3 grid the rig and a rig of 3
     cameras; the kernel is run several times on each; and after phase 13
     (it holds ~7 GB of the card) a chunk of more than 2^31 mask bytes
     bit-equal.  Bounds count the mask bytes at the counted sub-blocks'
     pixels (K1 and K4), and K1's colour bytes at occupied voxels;
 12. the offline path, ``VisualHull.process_frames_offline`` over the 16
     frames on the trained model: per-frame occupancy and colours equal to
     ``process_frame_fast``; K4 launches counted, ms/frame;
 13. K5 (single-phase labelling) on the foreground of the main-path
     frame, against its plain version: labels and iterations equal, times;
     then the inputs of phase 4 again;
 14. the reference's viewer seam, ``apps/assignment_api``, on the real
     rig: a data directory written with the port's own writers under
     ``build/`` (the cameras of ``artifacts/auto_extrinsics``, the board,
     the seeded background models as npz), frames painted from the rig's
     silhouettes ``artifacts/final/mask_cam*.png`` (read with ``zlib``)
     moving a few pixels; ``set_voxel_positions(128, 64, 128)`` over 8
     frames and the end of the stream, lists equal on the card and on the
     CPU, K1 and K2 launches counted, ms per call split into the step, the
     compaction and ``.tolist()``; the cameras equal to the host f64
     values; ``set_voxel_positions(100, 50, 100)`` (not divisible by
     8·sup) through the table step, card equal to CPU; the three
     ``masks`` cleanup routes equal; the projection-table cache built,
     then loaded;
 15. K1 and K4 at camera counts other than the rig's four (K1 55, 56,
     64, 300; K4 55, 56, 57, 64, 255, 300), which take the direct kernel,
     on random tables, bit-equal to their plain versions, with each launch
     plan (``scripts/bench_camera_counts.py`` times them at full size);
 16. the surface path at ``("cubes", "join")``, capacity 32768:
     ``VisualHull.process_frame_surface`` on phase 5's frame and on two of
     phase 14's rig frames, triangles, occupancy and colours bit-equal to
     the CPU (the CPU side runs ``surface_program`` on the occupancy it
     carved before, and ``extract_mesh`` where that reports more than the
     capacity), K1 and K2 launches counted, active cells and the 128-cell
     blocks they lie in (more than ``block_capacity`` = 4096 blocks, or
     more cells than the capacity, send the step's occupancy to
     ``extract_mesh``; a component-table overflow redoes the frame on the
     table path), triangles, whether either happened; ms per frame on both inputs beside ``process_frame_fast``;
     on the rig frame ``surface_program`` alone (device ms, bound, a
     profile), the triangle download and the host placement apart, the
     wire's host tail (``native.mc_emit``), and profiles of both steps;
     ``stream_surface`` over phase 6's 16 frames and over the rig's 8 with
     ``transfer="full"`` and ``"wire"``, each frame equal to
     ``process_frame_surface``, ms per frame; then, not timed, on the rig
     frame: ``("tetrahedra", "separate")`` and ``("cubes", "separate")``,
     a capacity below the active cells (``extract_mesh`` on the step's
     occupancy, same triangles),
     ``extract_surface`` equal to ``process_frame_surface``; three
     separated cubes through ``surface_program(block_capacity=2)``
     (forced over capacity, equal to the CPU); ``textured_frame`` card vs
     CPU; ``surface_program`` queued under
     ``torch.cuda.set_sync_debug_mode("error")``;
 17. the thin-link viewer stream on phase 14's rig:
     ``VisualHull.stream_viewer`` over its 8 frames with ``ingest="bgr"``,
     ``"yuv420"`` and ``"yuv420_roi"`` (window 320x224), every frame's
     (positions, rgb) bit-equal to the CPU's, for ``"bgr"`` also to
     ``compact_voxels_blocked`` of ``process_frame_fast(layout="blocked")``
     (the wire is lossless); ms/frame, K1 and K2 launches, the upload bytes
     of each mode, the frames the tracker sends to full-frame ``yuv420``
     and the wire's bytes; ``validate_reduced_ingest`` (``"yuv420"``,
     ``"yuv420_roi"``) on a rig frame, equal on the card and the CPU; one
     frame's wire byte-equal; a wire capacity below the frame's occupied
     sub-blocks and phase 7's component overflow, both redone exactly
     (equal to the CPU); ``stream_surface`` with both reduced uploads under
     both transfers, each frame equal to the CPU; on the host
     ``native.yuv420_pack`` byte-equal to the numpy pack and
     ``native.mc_emit`` bit-equal to the numpy emission, with the ms of
     each beside numpy's and the tracker's; and a viewer frame of each
     ingest queued up to its download under
     ``torch.cuda.set_sync_debug_mode("error")``.

 18. large grids: at phase 3's and phase 14's 128³ grids
     ``build_block_tables(accelerate=True)`` (f32 projection on the card,
     f64 host recheck of the boundary band) equal to their f64 host tables
     and ``build_projection_tables(accelerate=True)`` to
     ``accelerate=False``, both builds timed, the suspicious voxels per
     camera; the rig at 256³ (the model's own device build, equal to the
     same torch code on the CPU and, on two superblock x-slabs, to the f64
     projection; its peak memory and suspicious share):
     ``process_frame_fast`` over its 8 frames equal to the CPU and frame 0
     to ``carve_from_tables`` on the accelerated projection tables, K1
     bit-equal to its plain version with its time and bound,
     ``process_frames_offline`` over 8 frames equal to the CPU with K4
     bit-equal, timed and bounded, ``process_frame_surface`` on two frames
     equal to the CPU, with the path each took; an 8-camera synthetic rig
     at 512³: ``build_block_tables(accelerate=None)`` takes the device build
     (its 2048-voxel spot check, then 2^20 voxels per camera re-projected
     in f64), K1's direct route through ``carve_blocked`` equal to
     ``carve_from_tables`` on the accelerated projection tables,
     ``Reconstructor(use_tables=False)`` (``carve_fused``) within 0.01 % of
     it, ms per frame of the three carves and peak memory; and
     ``Reconstructor(use_tables=False)`` on the rig at 128³, card equal to
     CPU and within 0.01 % of the table path.
 19. intrinsic calibration on boards rendered on the card at the 134 real
     poses of ``artifacts/intrinsics_run`` (each camera's fitted K and
     distortion, 115 mm squares, 3×3 supersampling): the first f64 solve
     and the first forward-mode derivative timed apart; the corners
     method as ``cmd_calibrate`` runs it, ``detect_chessboard`` on every
     view on the card and on the CPU (the same views found, corners within
     1e-3 px; error against the true corners), ``calibrate_camera`` on the
     detected corners and on the true ones plus 0.3 px of seeded noise,
     card vs CPU within rtol 1e-6, ``discard_bad_image_points`` on cam1's
     first 12 views on both, ``save_camera_config`` read back bit for bit;
     the photometric method, ``calibrate_video_photometric`` (3000 steps)
     per camera, fx and fy within 1 % of the truth, the radial curve closer
     to it than the warm start's; on cam1 the loss and gradient at the warm
     start and the first 50 Adam steps card vs CPU, the CUDA graph
     bit-equal to the eager steps, ms per step of both, and ``fix_pp``
     pinning cx and cy; the seconds of each part and the peak memory.
 20. extrinsic calibration on boards rendered on the card at the rig's
     committed poses (``artifacts/auto_extrinsics``, 16 noisy frames per
     camera over a seeded textured background, 120 background frames, a
     person frame painted from ``artifacts/final``): ``auto_extrinsics``
     (400 photometric steps, orientation voted) recovers every pose within
     0.01 rad and 25 mm up to the global 180° frame; on cam1 the sheet,
     ``detect_black_squares`` and ``photometric_refine`` card vs CPU (and
     the CUDA graph bit-equal to the eager steps), the person masks and
     the vote card vs CPU with camera 2's candidate flipped;
     ``evaluate_pose_sets`` and ``hull_coverage`` /
     ``carve_silhouette_ab`` at 64³ (each single-camera flip loses
     coverage and voxels) card vs CPU; ``train_mog2`` and ``train_knn`` on
     phase 10's sequences (MOG2 on a band of camera 1's rows and its mask,
     KNN through the fill and ``apply_knn`` on the carried state, card vs
     CPU), ``raw_masks_batched`` card vs CPU, and ``BackgroundPipeline``
     from frames and from phase 14's npz models against the per-camera
     calls; ms per update and per photometric step, seconds of each part.
 21. the sharded production step (``vbr_tpu_torch/parallel``) on phase
     14's rig at its 128³ grid: (a) a one-rank NCCL group from a
     ``FileStore`` in a temporary directory and its (1, 1, 1) mesh;
     ``ShardedRunner`` with each superblock order (``"contiguous"``,
     ``"strided"``, ``"cost"``) over the 8 rig frames through ``__call__``
     and ``stream(depth=2)`` and after a ``rebalance``, bit-equal to
     ``process_frame_fast(layout="blocked")``, its K1 and K2 launches
     counted (``launches_sharded`` in the kernel rows: the strided run),
     the step's overflow bits equal to the single-device step's, ms per
     frame beside ``process_frame_fast``; ``extract_mesh_sharded`` equal to
     ``extract_mesh``, ``sharded_carve_step`` to ``carve_from_tables`` and
     ``sharded_pipeline_step`` (cleanup off and on) to the one-device
     apply, opening (cleanup) and table carve; the group destroyed.  (b)
     2, 4 and 8 shards emulated on the card for each order: every shard's
     ``local_table_slice`` carved by K1 (held against its plain version),
     the union bit-equal to the unsharded K1, per-shard K1 ms (max and
     mean) beside the unsharded K1; the same on phase 18's 8-camera 512³
     tables (kept from that phase); K2 on the 1, 2 and 4 images a shard
     labels at ``cam`` = 4, 2 and 1, equal to its plain version on the CPU.
     NCCL refuses two ranks on one card, so no collective of more than
     one rank runs here.
 22. the viewer's headless renderer (``viewer/headless.py``) on the
     card: phase 14's 8 rig frames through the viewer's ``G`` key
     (``app.recarve`` on a ``ViewerState``: ``BackgroundPipeline`` on the
     rig's models, ``Reconstructor.carve_frame`` and ``compact_voxels`` at
     ``AppConfig``'s 128 x (64·2) x 128 world), each rendered at 960x720
     with the 64 x 64 floor and the cameras from an eye on the CLI's
     ``--animate`` orbit (``orbit_pose``: radius 38, height 24, target
     (4, 6, 0), 8 eyes from -135 degrees), every image bit-equal to the same
     call on the CPU; frame 0 written by ``save_png`` under ``build/`` and
     read back equal by the script's own decoder; 2,200,000 seeded points
     of the 128³ lattice (the GL engine's instance capacity; repeats and
     tied depths included) rendered bit-equal to the CPU; render ms per
     frame for both (device-event medians), the CPU render's ms, the whole
     frame's ms (``recarve``, render, download) and its parts, a profile of
     each render (device-busy ms and device ops per render); and, for
     information, whether PyOpenGL, glfw and PIL import on the host.
 23. the CLI (``apps/cli.py``) on video files: a rig directory written by
     the port's own MJPEG writer under ``build/`` (the cameras of
     ``artifacts/auto_extrinsics``, 134 background frames per camera from
     the seeded background, 428 video frames of the rig's silhouettes
     walking 40 px across, 486x644 at 50 fps); every file's container
     count equal to the frames written; ``read_video``, ``frame_iterator``,
     ``get_frame`` and ``PrefetchingSource`` giving the same frames; the
     host's decode ms per 4-camera frame, one thread and four; then
     through ``cli.main`` at ``--grid 128``: ``pipeline`` over all frames
     (its training from video timed, K3 launches counted, and its stream
     loop timed again over 128 frames, beside the same step on frames
     decoded beforehand and ``process_frames_offline`` at 16 and 64
     frames), ``pipeline --offline 8``, ``masks`` (which trains and writes
     the background cache, equal to ``pipeline``'s model), ``carve``,
     ``carve --batched --frames 8``, ``mesh`` and ``render``, each
     command's kernel launches counted; the same commands with ``--cpu``
     on the card's cache (``pipeline`` over the first 4 frames),
     every output file byte-equal to the card's; a band of camera 1's
     model retrained on the CPU, bit-equal; ``calibrate --mode
     extrinsics`` on phase 20's scene written as MJPEG video, every pose
     within 0.01 rad and 25 mm; and ``calibrate`` of intrinsics with
     ``--discard`` on an MJPEG video of 8 boards rendered at cam1's real
     poses and a ninth with fy stretched 8 % (which it discards), on the
     card and with ``--cpu``: both write ``intrinsic_params_cam1.png``
     (1800x500), byte-equal where their printed digits agree, else with
     K within phase 19's rtol 1e-6.
 24. the manual corner session and the reports (``apps/manual_corners``,
     ``pipelines/reports``): ``ManualCornerSession`` on the 3 of phase
     19's cam1 boards whose inner corners lie nearest the clicked quad's
     homography, clicked at the projected true outer corners each moved
     a seeded 1-2 px, one click undone and made again, on the card and on
     the CPU: every refined corner within 1e-3 px, their distance to
     the true inner corners and ms per session printed;
     ``plot_mask_comparison`` of phase 20's KNN, MOG (the K3-trained
     model's raw masks) and MOG2 masks of one frame, read back at
     (600·3)x(500·C); ``plot_intrinsic_results`` of cam1's discard views
     calibrated "all views" and "after discard" on the card and on the
     CPU, read back at 1800x500, byte-equal where the printed digits
     agree (else within rtol 1e-6); ``render_mesh_snapshot`` of phase
     16's rig mesh at 128^3 on the card bit-equal to the CPU, its ms on
     both with the triangle count, ``plot_mesh_snapshot`` read back at
     1000x1000 equal to it; each figure's ms.

A kernel's time is the device's (``timed_ms``: a spin kernel ahead of
the start event keeps the host out of the interval; L2 is flushed by
reading, which leaves no dirty lines), and phase 2 prints what an empty
launch costs between the same two events (``launch_floor_ms``).

It prints one JSON line of per-kernel numbers, the card line, and as its
last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero without that line; so does a machine without CUDA.  It imports
nothing of JAX or of the ``vbr_tpu`` package.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
import dataclasses
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib
from types import SimpleNamespace

import numpy as np

SEED = 1234
STREAM_FRAMES = 16
TRAIN_FRAMES = 32  # background frames per camera in the training phase
TRAIN_CHUNK = 16  # frames per K3 launch (``train_mog``'s default)
OFFLINE_NF = 8  # frames per K4 launch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ALU_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# the change test is a compare inside each of the 5 passes
K2_OPS_PER_PIXEL_ITER = 21  # 4 diag compare+min, 4 scans × (compare+min), 5 change tests
K5_OPS_PER_PIXEL_ITER = 22  # 8 neighbour min, fg select, 4 scans × (select+min), 5 change tests
LABEL_CAP = 64  # ``max_iters`` of both labelling kernels in the pipeline
# names of the port's kernels as the profiler reports them
OWN_KERNELS = ("carve_blocked_kernel", "carve_frames_kernel", "ccl_",
               "mog_train_kernel")
KERNEL_RERUNS = 5  # runs of a labelling kernel on each of its test images


class Failed(Exception):
    pass


def expect(cond, what):
    if not cond:
        raise Failed(what)
    print(f"  ok: {what}", flush=True)


def mog_state(rng, bg_hsv, torch, K=50, n_slots=3):
    """A frozen 50-mixture MOG state whose first slots sit near the
    background HSV (weights from a Dirichlet, so bg_ratio 0.9 gives a
    small prefix Ke)."""
    from vbr_tpu_torch.ops.gmm import MOGState

    H, W = bg_hsv.shape[:2]
    w = np.zeros((H, W, K), np.float32)
    w[..., :n_slots] = rng.dirichlet([6.0, 3.0, 1.0][:n_slots], size=(H, W))
    mean = np.zeros((H, W, K, 3), np.float32)
    mean[..., :n_slots, :] = (bg_hsv[:, :, None, :].astype(np.float32)
                              + rng.normal(0, 3, (H, W, n_slots, 3)))
    var = np.zeros((H, W, K), np.float32)
    var[..., :n_slots] = rng.uniform(100.0, 200.0, (H, W, n_slots))
    return MOGState(weight=torch.from_numpy(w), mean=torch.from_numpy(mean),
                    var=torch.from_numpy(var),
                    nframes=torch.tensor(134, dtype=torch.int32))


def subject_texture(H, W):
    """The subject's BGR texture: dark (V < 24), so no background pixel of
    the synthetic rig (V >= 60) is within the model's match distance."""
    yy, xx = np.mgrid[:H, :W]
    return np.stack([xx % 24, yy % 24, np.zeros_like(xx)], -1).astype(np.uint8)


def paint_frame(rng, cams, bg, center, speckle=200, holes=4):
    """Background + the sphere's silhouettes in the subject texture, plus
    seeded speckle (small fg components) and holes (small bg ones)."""
    from vbr_tpu_torch.utils.synthetic import sphere_silhouette_mask

    H, W = bg.shape[1:3]
    sils = [sphere_silhouette_mask(cp, np.asarray(center), 500.0, (H, W)) > 0
            for cp in cams]
    return paint_silhouettes(rng, bg, sils, speckle, holes)


def paint_silhouettes(rng, bg, sils, speckle=200, holes=4):
    """Background + each camera's (H, W) bool silhouette in the subject
    texture, plus seeded speckle and holes."""
    H, W = bg.shape[1:3]
    tex = subject_texture(H, W)
    fr = bg.copy()
    for c, sil in enumerate(sils):
        fr[c][sil] = tex[sil]
        ys = rng.integers(0, H, speckle)
        xs = rng.integers(0, W, speckle)
        fr[c, ys, xs] = tex[ys, xs]
        sy, sx = np.nonzero(sil)
        for i in rng.integers(0, len(sy), holes):
            fr[c, sy[i]:sy[i] + 3, sx[i]:sx[i] + 3] = bg[
                c, sy[i]:sy[i] + 3, sx[i]:sx[i] + 3]
    return fr


SPIN_CYCLES = 400_000  # device clock cycles: ~200 us at the H100's 1.7-2 GHz


def timed_ms(fn, torch, dev, reps=20, flush=None, setup=None,
             spin_cycles=SPIN_CYCLES):
    """Median ms of ``fn`` over ``reps`` calls, ``flush()`` (a pass over a
    buffer larger than L2) before each.  With ``setup``, each call is
    ``fn(setup())`` and ``setup`` is not timed (for a kernel that updates
    its input in place).

    On the card the time is the device's: after the flush a spin kernel
    keeps the device busy for ``spin_cycles`` (~200 us), and only then come
    the start event, ``fn`` and the end event.  The host enqueues all three
    while the spin runs, so the interval between the events holds what
    ``fn`` launched and no wait for the host (as long as the host needs
    less than the spin for ``fn``; a plain version of many launches may
    not, and a function of many launches needs a longer spin).  On the CPU
    it is the host clock around ``fn``."""
    def args():
        return () if setup is None else (setup(),)

    fn(*args())
    times = []
    for _ in range(reps):
        a = args()
        if flush is not None:
            flush()
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin_cycles)
            s.record()
            fn(*a)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn(*a)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def bound(n_bytes, n_ops):
    """(least ms the card could take, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs_err(pairs):
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def background_sequence(rng, bg_c, T, sigma=3.0, flicker=0.03):
    """T training frames of one camera: its background image + per-pixel
    noise, and on a few pixels per frame a brighter colour, so that
    several mixture slots fill."""
    H, W = bg_c.shape[:2]
    fr = bg_c[None].astype(np.float32) + sigma * rng.standard_normal(
        (T, H, W, 3), dtype=np.float32)
    fr += 50.0 * (rng.random((T, H, W, 1), dtype=np.float32) < flicker)
    return np.clip(np.rint(fr), 0, 255).astype(np.uint8)


def train_state_from_mog(state, torch, nframes):
    """A mid-training ``MOGTrainState`` from an apply-facing state: the
    total variance split evenly over the channels, the stored key as a
    match leaves it (w / sqrt(Σv)), 0 on the empty slots."""
    from vbr_tpu_torch.ops.gmm import MOGTrainState

    K = state.weight.shape[-1]
    w = state.weight.reshape(-1, K).t().contiguous()
    varsum = state.var.reshape(-1, K).t()
    key = torch.where(w > 0, w / torch.sqrt(varsum.clamp_min(1e-6)), 0.0)
    return MOGTrainState(
        weight=w, sort_key=key.contiguous(),
        mean=state.mean.reshape(-1, K, 3).permute(2, 1, 0).contiguous(),
        var=(varsum / 3.0)[None].expand(3, -1, -1).contiguous(),
        nframes=torch.tensor(nframes, dtype=torch.int32))


def serpentine(H, W):
    """Every other row set, joined alternately at its right and left end:
    one corridor that the labelling fixpoint walks about two rows per
    iteration, so a tall one outlasts the iteration cap."""
    m = np.zeros((H, W), bool)
    m[::2] = True
    m[1::4, W - 1] = True
    m[3::4, 0] = True
    return m


def seam_images(H, W, bands=8):
    """(3, H, W): 1-px diagonal stripes in both directions, which cross
    every row seam diagonally, and columns that change phase exactly at
    the seams of ``bands`` equal bands of rows (every third column changes
    one row later, every fifth never)."""
    yy, xx = np.mgrid[:H, :W]
    R = max(H // bands, 1)
    cols = ((yy - (xx % 3 == 1)) // R) % 2 == 0
    cols[:, ::5] = True
    return np.stack([(yy + xx) % 4 == 0, (yy - xx) % 4 == 0, cols])


def crossing_sweeps(H, W, bands=8):
    """A block of columns 32-127 that each band of rows of ``bands`` reaches
    a second way: a spur from the band's last row to an upright spine whose
    label is lower the lower the band.  In the second iteration every band's
    column scans then meet in the block: the carry from the band above
    comes down while the lower label from the band's last row goes up.
    Columns 0-31 have nothing to carry."""
    R = H // bands
    m = np.zeros((H, W), bool)
    m[2 * bands + 4:, 32:128] = True
    for b in range(bands):
        last, spine = (b + 1) * R - 1, 160 + 4 * b
        m[last, 128:spine + 1] = True
        m[2 * (bands - b):last + 1, spine] = True
    return m


def mixed_batch(rng, B, H, W):
    """(B, H, W): image i holds a serpentine over its first 4 + 3·i rows
    (so the iteration counts differ) above sparse seeded noise."""
    out = rng.random((B, H, W)) < 0.1
    for i in range(B):
        rows = min(4 + 3 * i, H)
        out[i, :rows] = serpentine(rows, W)
        if rows < H:
            out[i, rows] = False
    return out


def per_iteration_us(torch, dev, fn, Hp, Wp, caps=(16, 48)):
    """µs per iteration of a labelling function on the serpentine at the
    production shape: the difference of two iteration caps it outlasts."""
    cor = torch.from_numpy(serpentine(Hp, Wp)[None]).to(dev)
    lo, hi = (timed_ms(lambda: fn(cor, max_iters=c), torch, dev, reps=9)
              for c in caps)
    return (hi - lo) * 1e3 / (caps[1] - caps[0])


def hold_labelling(torch, dev, name, kernel, fn, plain, large_hw, batch,
                   cap, Hp, Wp):
    """Hold a labelling kernel against its plain version, labels and
    iteration counts bit-equal, on the inputs the production frame does
    not reach; returns the largest difference seen."""
    from vbr_tpu_torch.ops import ccl_label

    rng = np.random.default_rng(SEED + 7)
    yy, xx = np.mgrid[:Hp, :Wp]
    corridor = serpentine(Hp, Wp)[None]
    # upright over a third of the width, which already outlasts the cap
    upright = np.zeros((1, Hp, Wp), bool)
    upright[0, :, :Wp // 3] = serpentine(Wp // 3, Hp).T
    cases = [
        ("corridor at the cap", corridor, cap),
        ("corridor to its fixpoint", corridor, 4 * Hp),
        ("upright corridor at the cap", upright, cap),
        ("upright corridor to its fixpoint", upright, 4 * Wp),
        ("dense random image", rng.random((1, Hp, Wp)) < 0.6, 2 * cap),
        ("crossing column sweeps, 2 iterations",
         crossing_sweeps(Hp, Wp)[None], 2),
        ("crossing column sweeps", crossing_sweeps(Hp, Wp)[None], cap),
        ("checkerboard", ((yy + xx) % 2 == 0)[None], cap),
        ("band seams", seam_images(Hp, Wp), cap),
        (f"batch of {batch}", mixed_batch(rng, batch, Hp, Wp), cap),
        ("too large for a cluster",
         rng.random((1, *large_hw)) < 0.2, cap),
        ("small", rng.random((1, 8, 128)) < 0.3, cap),
    ]
    worst = 0.0
    kept = {}
    for what, img, max_iters in cases:
        img_d = torch.from_numpy(img).to(dev)
        want, it_want = plain(img_d, max_iters=max_iters)
        route = (ccl_label.kernel_route(kernel, *img.shape[1:])
                 if dev.type == "cuda" else {"route": "plain (CPU)"})
        # the result must not depend on how the threads of a cluster
        # interleave
        for _ in range(KERNEL_RERUNS if route["route"] == "cluster" else 1):
            got, it = fn(img_d, max_iters=max_iters)
            sync(torch, dev)
            worst = max(worst, max_abs_err([(got, want), (it, it_want)]))
            if not (torch.equal(got, want) and torch.equal(it, it_want)):
                raise Failed(f"{name} {what} {tuple(img.shape)}: differs "
                             f"from the plain version; iterations "
                             f"{it.tolist()} against {it_want.tolist()}")
        its = it.tolist()
        shown = its if len(its) <= 4 else sorted(set(its))
        print(f"  ok: {name} {what} {tuple(img.shape)}: labels and "
              f"iterations bit-equal; iterations {shown}; route {route}",
              flush=True)
        kept[what] = (got, its, route)
    capped, full = kept["corridor at the cap"], kept["corridor to its fixpoint"]
    expect(capped[1] == [cap] and cap < full[1][0] < 4 * Hp
           and not torch.equal(capped[0], full[0]),
           f"{name}: the cap cut the corridor short at {cap} iterations "
           f"(fixpoint after {full[1][0]}), and the labels differ")
    capped, full = (kept["upright corridor at the cap"],
                    kept["upright corridor to its fixpoint"])
    expect(capped[1] == [cap] and cap < full[1][0] < 4 * Wp
           and not torch.equal(capped[0], full[0]),
           f"{name}: the cap cut the upright corridor short too (fixpoint "
           f"after {full[1][0]})")
    expect(len(set(kept[f"batch of {batch}"][1])) > 2,
           f"{name}: iteration counts differ within the batch")
    if dev.type == "cuda":
        expect(kept["too large for a cluster"][2]["route"] == "general"
               and kept["small"][2]["cluster"] == 1
               and kept[f"batch of {batch}"][2]["route"] == "cluster",
               f"{name}: the large shape took the general route, the small "
               "one a cluster of 1, the batch the cluster route")
    return worst


def hold_carve(torch, dev, cb, cams, image_hw, btab, masks, frame_d, vt):
    """Hold K1 against its plain version, occupancy and colours bit-equal,
    on inputs the production frame does not reach: every sub-block
    inactive, every sub-block with valid projections full, a lower view
    threshold, random masks, and on a 32^3 grid (fewer sub-blocks than the
    card holds CTAs) another colour camera and a 3-camera rig (the direct
    kernel).  The kernel is run several times on
    each; returns the largest difference seen and what each case held."""
    from vbr_tpu_torch.utils.config import GridConfig

    rng = np.random.default_rng(SEED + 11)
    small = GridConfig(nx=32, ny=32, nz=32)
    tab_cc = cb.build_block_tables(cams, small, image_hw, color_camera=2,
                                   device=dev)
    tab_3 = cb.build_block_tables(cams[:3], small, image_hw, color_camera=0,
                                  device=dev)
    noise = torch.from_numpy(
        (rng.random(tuple(masks.shape)) < 0.5).astype(np.uint8) * 255).to(dev)
    cases = [
        ("all masks empty", btab, torch.zeros_like(masks), vt),
        ("all masks full", btab, torch.full_like(masks, 255), vt),
        ("views_threshold 3 of 4", btab, masks, 3),
        ("random masks, threshold 2", btab, noise, 2),
        ("32^3 grid, colour camera 2", tab_cc, masks, vt),
        ("32^3 grid, 3 cameras", tab_3, masks[:3].contiguous(), 3),
    ]
    worst, kept = 0.0, {}
    for what, tab, m, thr in cases:
        active, full = cb.block_activity(m, thr, tab.allv, tab.ry, tab.rx)
        args = (tab.pk, tab.lcc, active, full, m,
                frame_d[tab.color_camera].contiguous())
        kw = dict(color_camera=tab.color_camera, views_threshold=thr)
        want = cb.carve_blocked_plain(*args, **kw)
        for _ in range(KERNEL_RERUNS if dev.type == "cuda" else 1):
            got = cb.carve_blocked_kernel(*args, **kw)
            sync(torch, dev)
            worst = max(worst, max_abs_err(zip(got, want)))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise Failed(f"K1 {what}: differs from the plain version")
        nblk = tab.nsuper * tab.nsub
        plan = (cb.k1_launch_plan(nblk, tab.num_cameras)
                if dev.type == "cuda" else None)
        kept[what] = dict(
            nblk=nblk, active=int((active > 0).sum()),
            full=int(((active > 0) & (full > 0)).sum()),
            occupied=int(got[0].sum()), coloured=int((got[1] > 0).sum()),
            plan=plan)
        print(f"  ok: K1 {what}: occupancy and colours bit-equal; "
              f"{kept[what]}", flush=True)
    empty, allfg = kept["all masks empty"], kept["all masks full"]
    expect(empty["active"] == 0 and empty["occupied"] == 0,
           "K1: with empty masks no sub-block is active and no voxel set")
    expect(allfg["occupied"] >= allfg["full"] * cb.BV > 0
           or dev.type == "cpu" and allfg["occupied"] > 0,
           "K1: with full masks the sub-blocks whose projections are all "
           "valid are full and set every voxel")
    expect(kept["views_threshold 3 of 4"]["occupied"]
           > kept["32^3 grid, colour camera 2"]["occupied"] > 0
           and kept["32^3 grid, 3 cameras"]["occupied"] > 0
           and 0 < kept["random masks, threshold 2"]["occupied"],
           "K1: every other case sets some voxels")
    if dev.type == "cuda":
        few = kept["32^3 grid, 3 cameras"]
        nblk, big = empty["nblk"], empty["plan"]
        expect(big["c_static"] and not few["plan"]["c_static"]
               and few["plan"]["ctas"] == few["nblk"]
               and big["ctas"] < nblk and nblk % big["ctas"] != 0,
               f"K1: the rig's camera count is compiled in, 3 cameras take "
               f"the direct kernel; {few['nblk']} sub-blocks take as many "
               f"CTAs, {nblk} take {big['ctas']} (not a divisor)")
    return worst


def hold_frames(torch, dev, cb, cams, image_hw, btab, masks8, vt):
    """Hold K4 against its plain version, occupancy bit-equal, on inputs the
    production chunk does not reach: every sub-block inactive, every
    sub-block with valid projections full, random masks, a lower view
    threshold, a chunk that is full in one frame only, chunks of 1, 5, 9
    and 16 frames (the frame group's tail, more frames than one group), and
    on a 32^3 grid (fewer sub-blocks than the card holds CTAs) the rig and a
    3-camera rig (the direct kernel).  The kernel is
    run several times on each; returns the largest difference seen."""
    from vbr_tpu_torch.utils.config import GridConfig

    rng = np.random.default_rng(SEED + 17)
    small = GridConfig(nx=32, ny=32, nz=32)
    tab_s = cb.build_block_tables(cams, small, image_hw, device=dev)
    tab_3 = cb.build_block_tables(cams[:3], small, image_hw, color_camera=0,
                                  device=dev)
    NF = masks8.shape[0]
    noise = torch.from_numpy(
        (rng.random(tuple(masks8.shape)) < 0.5).astype(np.uint8) * 255).to(dev)
    one_full = masks8.clone()
    one_full[NF // 2] = 255

    def frames(n):  # frame i is masks8[i % NF]
        return masks8[torch.arange(n, device=dev) % NF].contiguous()

    cases = [
        ("all masks empty", btab, torch.zeros_like(masks8), vt),
        ("all masks full", btab, torch.full_like(masks8, 255), vt),
        ("random masks, threshold 2", btab, noise, 2),
        ("views_threshold 3 of 4", btab, masks8, 3),
        ("full in one frame only", btab, one_full, vt),
        ("NF = 1", btab, frames(1), vt),
        ("NF = 5", btab, frames(5), vt),
        ("NF = 9", btab, frames(9), vt),
        ("NF = 16", btab, frames(16), vt),
        ("32^3 grid", tab_s, masks8, vt),
        ("32^3 grid, 3 cameras", tab_3, masks8[:, :3].contiguous(), 3),
    ]
    worst, kept = 0.0, {}
    for what, tab, m, thr in cases:
        active, full = cb.chunk_activity(m, tab, thr)
        args = (tab.pk, active, full, m)
        want = cb.carve_frames_plain(*args, views_threshold=thr)
        for _ in range(KERNEL_RERUNS if dev.type == "cuda" else 1):
            got = cb.carve_frames_kernel(*args, views_threshold=thr)
            sync(torch, dev)
            worst = max(worst, max_abs_err([(got, want)]))
            if not torch.equal(got, want):
                raise Failed(f"K4 {what}: differs from the plain version")
        nblk = tab.nsuper * tab.nsub
        plan = (cb.k4_launch_plan(nblk, tab.num_cameras, m.shape[0])
                if dev.type == "cuda" else None)
        kept[what] = dict(
            nblk=nblk, frames=m.shape[0], active=int((active > 0).sum()),
            full=int(((active > 0) & (full > 0)).sum()),
            occupied=got.flatten(1).sum(dim=1).tolist(), plan=plan)
        print(f"  ok: K4 {what}: occupancy bit-equal; {kept[what]}",
              flush=True)
    empty, allfg = kept["all masks empty"], kept["all masks full"]
    expect(empty["active"] == 0 and not any(empty["occupied"]),
           "K4: with empty masks no sub-block is active and no voxel set")
    expect(min(allfg["occupied"]) >= allfg["full"] * cb.BV > 0
           or dev.type == "cpu" and min(allfg["occupied"]) > 0,
           "K4: with full masks the sub-blocks whose projections are all "
           "valid are full and set every voxel in every frame")
    one = kept["full in one frame only"]["occupied"]
    expect(one[NF // 2] > max(one[:NF // 2] + one[NF // 2 + 1:]),
           "K4: the frame that is all foreground sets the most voxels")
    base = kept["views_threshold 3 of 4"]["occupied"]
    prod = cb.carve_frames_plain(
        btab.pk, *cb.chunk_activity(masks8, btab, vt), masks8,
        views_threshold=vt).flatten(1).sum(dim=1).tolist()
    expect(all(min(a, b) > 0 and a > b for a, b in zip(base, prod)),
           "K4: a view threshold of 3 sets more voxels in every frame")
    for n in (1, 5, 9, 16):
        got_n = kept[f"NF = {n}"]["occupied"]
        expect(got_n == [prod[i % NF] for i in range(n)],
               f"K4: a chunk of {n} frames sets the voxels of its frames")
    expect(min(kept["random masks, threshold 2"]["occupied"]) > 0
           and min(kept["32^3 grid"]["occupied"]) > 0
           and min(kept["32^3 grid, 3 cameras"]["occupied"]) > 0,
           "K4: random masks and both 32^3 rigs set voxels in every frame")
    if dev.type == "cuda":
        few = kept["32^3 grid, 3 cameras"]
        nblk, big = empty["nblk"], empty["plan"]
        expect(big["c_static"] and big["nf_static"]
               and not kept["NF = 9"]["plan"]["nf_static"]
               and not few["plan"]["c_static"]
               and few["plan"]["ctas"] == few["nblk"]
               and big["ctas"] < nblk,
               f"K4: the rig's camera count and the chunk of {NF} frames are "
               f"compiled in, 9 frames run the run-time loop and 3 cameras "
               f"the direct kernel; "
               f"{few['nblk']} sub-blocks take as many CTAs, {nblk} take "
               f"{big['ctas']}")
    return worst


def hold_frames_limits(torch, dev, cb):
    """K4 on a chunk of more than 2^31 mask bytes (514 frames of 4 x 1022 x
    1023, random tables of 16 sub-blocks), on the card, held bit-equal
    against the plain version.  Returns the largest difference seen."""
    NF, C, H, W, nblk = 514, 4, 1022, 1023, 16
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    pk = random_tables(torch, dev, cb, g, nblk, C, H, W)
    masks = torch.randint(0, 2, (NF, C, H, W), generator=g, device=dev,
                          dtype=torch.uint8) * 255
    active = torch.ones(nblk, dtype=torch.int32, device=dev)
    full = torch.zeros_like(active)
    active[5], full[3] = 0, 1
    want = cb.carve_frames_plain(pk, active, full, masks, views_threshold=2)
    worst = 0.0
    for _ in range(KERNEL_RERUNS):
        got = cb.carve_frames_kernel(pk, active, full, masks,
                                     views_threshold=2)
        sync(torch, dev)
        worst = max(worst, max_abs_err([(got, want)]))
        if not torch.equal(got, want):
            raise Failed(f"K4 on {masks.numel()} mask bytes differs from the "
                         "plain version")
    occupied = got.flatten(1).sum(dim=1)
    expect(masks.numel() > 2**31 and int(occupied[-1]) > 0,
           f"K4 occupancy bit-equal on a chunk of {masks.numel()} mask bytes; "
           f"occupied voxels in the last frame {int(occupied[-1])}")
    del masks, want, got
    torch.cuda.empty_cache()
    return worst


def random_tables(torch, dev, cb, g, nblk, C, H, W):
    """Random packed geometry words (1, nblk, C, BV) for (H, W) masks, one
    projection in seven outside the image."""
    shape = (1, nblk, C, cb.BV)
    row = torch.randint(0, H, shape, generator=g, device=dev,
                        dtype=torch.int32)
    x = torch.randint(0, W, shape, generator=g, device=dev, dtype=torch.int32)
    row[..., ::7] = cb.INVALID_ROW
    return (row << 10) | ((x // cb.WORD_BITS) << 3) | (x % cb.WORD_BITS)


K1_CAMERA_COUNTS = (55, 56, 64, 300)
K4_CAMERA_COUNTS = (55, 56, 57, 64, 255, 300)


def hold_camera_counts(torch, dev, cb, H=24, W=40, nblk=40, NF=OFFLINE_NF):
    """K1 and K4 at camera counts other than the rig's four, which take the
    direct kernel (tables read from device memory, K4 with 32-bit counters,
    so past 254 cameras too): random tables of ``nblk`` sub-blocks
    (some inactive, some full), random (H, W) masks at half foreground and a
    view threshold of 3/7 of the cameras, so that occupancy is mixed; each
    kernel bit-equal to its plain version, several runs each, its launch
    plan printed.  Returns the largest difference seen by kernel."""
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    reruns = KERNEL_RERUNS if dev.type == "cuda" else 1
    worst, routes = {"K1": 0.0, "K4": 0.0}, {}

    def flags():
        active = (torch.rand(nblk, generator=g, device=dev) < 0.8).int()
        full = (torch.rand(nblk, generator=g, device=dev) < 0.2).int()
        return active, full

    for C in sorted(set(K1_CAMERA_COUNTS + K4_CAMERA_COUNTS)):
        pk = random_tables(torch, dev, cb, g, nblk, C, H, W)
        thr = 3 * C // 7
        if C in K1_CAMERA_COUNTS:
            lcc = torch.randint(-1, W, (1, nblk, cb.BV), generator=g,
                                device=dev, dtype=torch.int32)
            masks = torch.randint(0, 2, (C, H, W), generator=g, device=dev,
                                  dtype=torch.uint8) * 255
            image = torch.randint(0, 256, (H, W, 3), generator=g, device=dev,
                                  dtype=torch.uint8)
            args = (pk, lcc, *flags(), masks, image)
            kw = dict(color_camera=C // 3, views_threshold=thr)
            want = cb.carve_blocked_plain(*args, **kw)
            for _ in range(reruns):
                got = cb.carve_blocked_kernel(*args, **kw)
                sync(torch, dev)
                worst["K1"] = max(worst["K1"], max_abs_err(zip(got, want)))
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise Failed(f"K1 with {C} cameras differs from the plain "
                                 "version")
            plan = cb.k1_launch_plan(nblk, C) if dev.type == "cuda" else None
            routes[("K1", C)] = plan and plan["route"]
            n = int(got[0].sum())
            expect(0 < n < nblk * cb.BV,
                   f"K1 with {C} cameras: occupancy and colours bit-equal; "
                   f"{n} voxels set; launch {plan}")
        if C in K4_CAMERA_COUNTS:
            masks = torch.randint(0, 2, (NF, C, H, W), generator=g,
                                  device=dev, dtype=torch.uint8) * 255
            active, full = flags()
            want = cb.carve_frames_plain(pk, active, full, masks,
                                         views_threshold=thr)
            for _ in range(reruns):
                got = cb.carve_frames_kernel(pk, active, full, masks,
                                             views_threshold=thr)
                sync(torch, dev)
                worst["K4"] = max(worst["K4"], max_abs_err([(got, want)]))
                if not torch.equal(got, want):
                    raise Failed(f"K4 with {C} cameras differs from the plain "
                                 "version")
            plan = (cb.k4_launch_plan(nblk, C, NF) if dev.type == "cuda"
                    else None)
            routes[("K4", C)] = plan and plan["route"]
            n = got.flatten(1).sum(dim=1).tolist()
            expect(0 < min(n) and max(n) < nblk * cb.BV,
                   f"K4 with {C} cameras, {NF} frames: occupancy bit-equal; "
                   f"voxels set per frame {n}; launch {plan}")
    if dev.type == "cuda":
        expect(set(routes.values()) == {"direct"},
               f"every camera count but the rig's takes the direct kernel: "
               f"{routes}")
    return worst


def clone_train_state(st):
    """A copy of a ``MOGTrainState`` for a kernel that updates in place."""
    return type(st)(*(a if a is None else a.clone() for a in st))


def random_chunk(rng, T, H, W):
    """T frames of uniform random u8 colours: a pixel matches no slot on
    most frames, so its mixture opens a new slot nearly every frame."""
    return rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)


def hold_training(torch, dev, gmm, ts0, image_hw, params):
    """Hold K3 against its plain version, all four state arrays, ``nframes``
    and the carried ``used`` mark bit-equal, on inputs the background
    sequence does not reach: random frames on the mid-training state (a
    pixel passes the slots the kernel caches, so slots live in both
    residences and move between them), the same with one and two cached
    slots, K = 3 and K = 1, an image of 37x53 pixels, a single frame, a
    state handed over without its mark, and two chunks in a row.  The
    kernel is run several times on each; returns the largest difference
    and the most slots a pixel of the first case uses."""
    from vbr_tpu_torch.utils.config import MOGParams

    rng = np.random.default_rng(SEED + 13)
    names = ("weight", "sort_key", "mean", "var")
    reruns = KERNEL_RERUNS if dev.type == "cuda" else 1
    worst = 0.0

    def hold(what, st, frames, p, cache_slots=None):
        """kernel(st, frames) == plain(st, frames), ``reruns`` times;
        returns the kernel's state (with its ``used``)."""
        nonlocal worst
        fr = torch.from_numpy(frames).to(dev)
        want = gmm.train_chunk_plain(st, fr, p)
        mark = gmm.slot_high_water(want.weight, want.sort_key)
        for _ in range(reruns):
            if cache_slots is None:
                got = gmm.train_chunk_kernel(clone_train_state(st), fr, p)
            else:
                got = gmm._launch_k3(clone_train_state(st), fr, p,
                                     cache_slots)
            sync(torch, dev)
            worst = max(worst, max_abs_err(
                (getattr(got, n), getattr(want, n)) for n in names))
            same = all(torch.equal(getattr(got, n), getattr(want, n))
                       for n in names + ("nframes",))
            if not same or (got.used is not None
                            and not torch.equal(got.used, mark)):
                raise Failed(f"K3 {what}: differs from the plain version"
                             + ("" if not same else " in the carried mark"))
        print(f"  ok: K3 {what}: state, nframes and mark bit-equal; slots "
              f"per pixel mean {float(mark.float().mean()):.2f}, max "
              f"{int(mark.max())}", flush=True)
        return got, int(mark.max())

    H, W = image_hw
    noise = random_chunk(rng, TRAIN_CHUNK, H, W)
    _, deepest = hold("random frames on the mid-training state", ts0, noise,
                      params)
    if dev.type == "cuda":
        for slots in (1, 2):
            hold(f"the same with {slots} cached slot(s)", ts0, noise, params,
                 cache_slots=slots)
    h, w = 37, 53  # HW % 128 != 0 and HW % 4 != 0
    for K in (3, 1):
        p = MOGParams(n_mixtures=K, history=12)
        hold(f"K = {K}, {h}x{w}, 16 random frames from an empty state",
             gmm.init_train_state((h, w), p, dev),
             random_chunk(rng, 16, h, w), p)
    p = MOGParams(history=20)
    st = gmm.init_train_state((h, w), p, dev)
    st, _ = hold(f"{h}x{w}, a single frame", st, random_chunk(rng, 1, h, w),
                 p)
    for i in range(2):  # the mark and nframes carried from chunk to chunk
        frames = random_chunk(rng, 16, h, w)
        frames[:, :, : w // 2] //= 32  # half the image matches now and then
        st, _ = hold(f"{h}x{w}, chunk {i + 1} of two in a row (16 frames, "
                     "across the history clamp)", st, frames, p)
    hold(f"{h}x{w}, the state handed over without its mark",
         st._replace(used=None), random_chunk(rng, 4, h, w), p)
    return worst, deepest


def seeded_rig(torch, image_hw, focal):
    """What every phase draws from ``SEED``, in this order: the 4 cameras,
    the background image, each camera's seeded MOG state, the first frame
    and the ``STREAM_FRAMES`` frames of the stream.  Returns them with the
    generator, which the later phases go on drawing from."""
    from vbr_tpu_torch.ops.color import bgr_to_hsv_u8
    from vbr_tpu_torch.utils.synthetic import synthetic_cameras, synthetic_rig

    rng = np.random.default_rng(SEED)
    cams = synthetic_cameras(4, image_hw=image_hw, f=focal)
    bg = synthetic_rig(image_hw=image_hw)[2]
    bg_hsv = bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    states = [mog_state(rng, bg_hsv[c], torch) for c in range(len(cams))]
    center0 = np.array([100.0, -50.0, -700.0])
    frame0 = paint_frame(rng, cams, bg, center0)
    seq = [paint_frame(rng, cams, bg, center0 + [12.0 * i, -6.0 * i, 0.0])
           for i in range(STREAM_FRAMES)]
    return SimpleNamespace(rng=rng, cams=cams, bg=bg, states=states,
                           image_hw=image_hw, center0=center0, frame0=frame0,
                           seq=seq)


def seeded_model(r, device, grid=None, mask_params=None):
    """A ``VisualHull`` of the seeded rig ``r`` on ``device`` with its
    seeded MOG states, its tables built."""
    from vbr_tpu_torch.models.visual_hull import VisualHull
    from vbr_tpu_torch.utils.config import (
        DEFAULT_MASK_PARAMS, GridConfig, MOGParams, RigConfig)

    m = VisualHull(r.cams, grid or GridConfig(),
                   RigConfig(image_height=r.image_hw[0],
                             image_width=r.image_hw[1]),
                   mask_params or DEFAULT_MASK_PARAMS, device=device)
    m.bg_states = r.states
    m.mog_params = [MOGParams()] * len(r.cams)
    m._ensure_fast_state()
    m._ensure_btab()
    return m


def k4_chunk(torch, cb, model, seq):
    """Phase 11's inputs: the masks of the first ``OFFLINE_NF`` frames of
    ``seq`` on ``model`` and their chunk flags, (masks, active, full)."""
    masks = torch.stack([model.masks(f) for f in seq[:OFFLINE_NF]])
    active, full = cb.chunk_activity(masks, model._btab,
                                     model.rig.views_threshold)
    return masks, active, full


def mask_bytes_read(torch, cb, pk, blocks, W):
    """Distinct mask bytes that the valid projections of the sub-blocks
    ``blocks`` (a bool per sub-block) address in one frame, summed over the
    cameras: what a carve that reads only the counted sub-blocks' pixels
    must read of each frame's masks."""
    p = pk.flatten(0, 1)[blocks]  # (n, C, BV)
    row = p >> 10
    lin = row * W + ((p >> 3) & 127) * cb.WORD_BITS + (p & 7)
    valid = row != cb.INVALID_ROW
    return sum(int(torch.unique(lin[:, c][valid[:, c]]).numel())
               for c in range(p.shape[1]))


def k1_work(torch, cb, btab, active, full, masks, occ_b):
    """What one K1 launch on ``masks`` must move and compute, and the
    bound that gives: the flags, the words of the counted sub-blocks (and
    the colour camera's of the full ones), the mask bytes the counted
    sub-blocks' pixels address, the colour frame's pixels of the occupied
    voxels (the plain version's gather) and ``lcc`` there, and the outputs
    (occupancy + 3 colour bytes per voxel) → namespace (bound, bound_by,
    active fraction, text)."""
    W = masks.shape[-1]
    nblk, C = btab.nsuper * btab.nsub, btab.num_cameras
    act, ful = active.bool(), full.bool()
    n_compute, n_full = int((act & ~ful).sum()), int(ful.sum())
    n_occ = int(occ_b.sum())
    mask_bytes = mask_bytes_read(torch, cb, btab.pk, act & ~ful, W)
    row_c = btab.pk[..., btab.color_camera, :] >> 10
    lit = (occ_b > 0) & (row_c != cb.INVALID_ROW) & (btab.lcc >= 0)
    colour_bytes = 3 * int(torch.unique((row_c * W + btab.lcc)[lit]).numel())
    n_bytes = (8 * nblk + n_compute * C * cb.BV * 4 + n_full * cb.BV * 4
               + n_occ * 4 + mask_bytes + colour_bytes + nblk * cb.BV * 4)
    n_ops = n_compute * cb.BV * C * 8  # decode, compare, add per view
    b, by = bound(n_bytes, n_ops)
    active_fraction = float(act.float().mean())
    return SimpleNamespace(
        bound=b, bound_by=by, active=active_fraction,
        text=(f"bound {b:.5f} ms ({by}: {n_bytes} B, {n_ops} ops); active "
              f"{active_fraction:.4f} of {nblk} sub-blocks, full {n_full}, "
              f"occupied voxels {n_occ}; mask bytes read {mask_bytes} of "
              f"{masks.numel()}, colour bytes {colour_bytes}"))


def k4_work(torch, cb, btab, active, full, masks, occ):
    """K4's counterpart of :func:`k1_work` for a chunk of (NF, C, H, W)
    masks: flags, the counted sub-blocks' words, the mask bytes they
    address in every frame, the occupancy out."""
    NF, W = masks.shape[0], masks.shape[-1]
    nblk, C = btab.nsuper * btab.nsub, btab.num_cameras
    act, ful = active.bool(), full.bool()
    n_compute = int((act & ~ful).sum())
    mask_bytes = NF * mask_bytes_read(torch, cb, btab.pk, act & ~ful, W)
    n_bytes = 8 * nblk + n_compute * C * cb.BV * 4 + mask_bytes + occ.numel()
    n_ops = n_compute * cb.BV * C * (5 + 2 * NF)
    b, by = bound(n_bytes, n_ops)
    return SimpleNamespace(
        bound=b, bound_by=by, active=float(act.float().mean()),
        text=(f"bound {b:.5f} ms ({by}: {n_bytes} B, {n_ops} ops); active "
              f"on the union {float(act.float().mean()):.4f} of {nblk} "
              f"sub-blocks, full on the intersection {int(ful.sum())}, "
              f"counted {n_compute}; mask bytes they address {mask_bytes} "
              f"of {masks.numel()}"))


def read_png(path):
    """An 8-bit grayscale or RGB, non-interlaced PNG as an (H, W) or
    (H, W, 3) u8 array, with the standard library's zlib (no image library
    on the card's host): the five row filters of the PNG standard, each
    byte predicted from the byte one pixel to its left."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    W, H, depth, colour, _, _, interlace = head
    if depth != 8 or colour not in (0, 2) or interlace != 0:
        raise ValueError(f"{path}: not 8-bit grayscale or RGB without "
                         "interlace")
    bpp = 1 if colour == 0 else 3  # bytes per pixel
    n = W * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(H, n + 1)
    out = np.zeros((H, n), np.uint8)
    up = np.zeros(n, np.int64)
    for y in range(H):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:  # None
            cur = line
        elif kind == 1:  # Sub: x = r + left, a running sum mod 256
            cur = (np.cumsum(line.reshape(W, bpp), axis=0) % 256).reshape(n)
        elif kind == 2:  # Up
            cur = (line + up) % 256
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left
            cur = np.zeros(n, np.int64)
            for x in range(n):
                left = int(cur[x - bpp]) if x >= bpp else 0
                up_left = int(up[x - bpp]) if x >= bpp else 0
                above = int(up[x])
                if kind == 3:
                    pred = (left + above) // 2
                else:
                    p = left + above - up_left
                    pa, pb, pc = abs(p - left), abs(p - above), abs(p - up_left)
                    pred = (left if pa <= pb and pa <= pc
                            else above if pb <= pc else up_left)
                cur[x] = (int(line[x]) + pred) % 256
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[y] = cur
        up = cur
    return out if bpp == 1 else out.reshape(H, W, 3)


def read_png_gray(path):
    """``read_png`` of an 8-bit grayscale PNG: (H, W) u8."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: not 8-bit grayscale")
    return img


RIG_DIR = "artifacts/auto_extrinsics"  # the 4-camera rig, cam{i}_config.xml
RIG_MASKS = "artifacts/final/mask_cam{}.png"  # its cleaned silhouettes
RIG_HW = (486, 644)  # the size those are calibrated and drawn at
RIG_FRAMES = 8
# (dy, dx) of each rig frame's silhouettes: a subject that moves a little
RIG_SHIFTS = ((0, 0), (0, 0), (1, 2), (2, 4), (3, 6), (-1, -2), (-2, -4),
              (0, 3))


def rig_cameras(image_hw):
    """The rig's (K, dist, rvec, tvec) per camera from ``RIG_DIR``, the
    intrinsics scaled from ``RIG_HW`` to ``image_hw``."""
    from vbr_tpu_torch.utils import xmlio

    sy, sx = image_hw[0] / RIG_HW[0], image_hw[1] / RIG_HW[1]
    cams = []
    for i in range(1, 5):
        K, dist, rvec, tvec = xmlio.load_camera_config(RIG_DIR,
                                                       f"cam{i}_config.xml")
        K = K * np.array([[sx], [sy], [1.0]])
        cams.append((K, dist, rvec, tvec))
    return cams


def rig_silhouettes(image_hw):
    """(4, H, W) bool: the rig's silhouettes, subsampled to ``image_hw``."""
    H, W = image_hw
    ys = np.arange(H) * RIG_HW[0] // H
    xs = np.arange(W) * RIG_HW[1] // W
    return np.stack([read_png_gray(RIG_MASKS.format(i))[np.ix_(ys, xs)] > 0
                     for i in range(1, 5)])


def write_rig_data(root, image_hw, states):
    """A data directory of the rig as the seam reads it, written with the
    port's own writers: ``cam{i}/config.xml``, ``checkerboard.xml`` and the
    background models ``models/mog_cam{i}.npz`` (compressed, as both
    packages write them, by one thread each: ~1.25 GB at full size).
    Returns (data directory, models directory)."""
    from vbr_tpu_torch.utils import artifacts, xmlio

    data = f"{root}/seam_rig_{image_hw[0]}x{image_hw[1]}"
    shutil.rmtree(data, ignore_errors=True)
    for i, cam in enumerate(rig_cameras(image_hw), start=1):
        xmlio.save_camera_config(f"{data}/cam{i}", *cam)
    xmlio.save_storage(f"{data}/checkerboard.xml",
                       {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
                        "CheckerBoardSquareSize": 115})
    with ThreadPoolExecutor(len(states)) as pool:  # zlib frees the GIL
        list(pool.map(artifacts.save_mog_state,
                      [f"{data}/models/mog_cam{i}.npz"
                       for i in range(1, len(states) + 1)], states))
    return data, f"{data}/models"


def seam_calls(api, data, models, frames, size, device, model_kw):
    """``assignment_api`` configured on ``data`` and driven through
    ``frames`` and one call past their end: (each call's (positions,
    colors), the end's, each call's host ms, the module's model)."""
    from vbr_tpu_torch.utils.video import ArraySource

    api.configure(data, ArraySource(frames), models, device=device,
                  **model_kw)
    outs, ms = [], []
    for _ in frames:
        t0 = time.perf_counter()
        outs.append(api.set_voxel_positions(*size))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, api.set_voxel_positions(*size), ms, api._model


def seam_phase(torch, dev, kernels, r, mask_params, image_hw, sizes,
               build_root="build"):
    """Phase 14: the reference's viewer seam, ``assignment_api``, on the
    rig's geometry and silhouettes (see ``run``).  Returns its report and
    the rig's models on the card and on the CPU with its frames (for
    phase 16)."""
    from vbr_tpu_torch.apps import assignment_api as api
    from vbr_tpu_torch.models.visual_hull import VisualHull
    from vbr_tpu_torch.ops import carve as carve_ops
    from vbr_tpu_torch.pipelines import reconstruction
    from vbr_tpu_torch.utils.config import (
        DEFAULT_MASK_PARAMS, CameraParams, RigConfig)

    H, W = image_hw
    size, size_tables = sizes
    t0 = time.perf_counter()
    data, models = write_rig_data(build_root, image_hw, r.states)
    sils = rig_silhouettes(image_hw)
    frames = np.stack([
        paint_silhouettes(r.rng, r.bg, np.roll(sils, shift, axis=(1, 2)))
        for shift in RIG_SHIFTS[:RIG_FRAMES]])
    print(f"  rig data written and {RIG_FRAMES} frames painted in "
          f"{time.perf_counter() - t0:.2f} s; foreground of the silhouettes "
          f"{np.round(sils.mean(axis=(1, 2)), 4).tolist()}")
    model_kw = dict(rig=RigConfig(image_height=H, image_width=W),
                    mask_params=mask_params or DEFAULT_MASK_PARAMS)

    for k in kernels:
        k.launches = 0
    outs, end, ms, model = seam_calls(api, data, models, frames, size, dev,
                                      model_kw)
    sync(torch, dev)
    seam_launches = {k.source.stem: k.launches for k in kernels}
    n_occ = [len(p) for p, _ in outs]
    expect(end == ([], []) and min(n_occ) > 0
           and (dev.type == "cpu" or seam_launches["carve_blocked"]
                >= RIG_FRAMES <= seam_launches["ccl_combined"]),
           f"set_voxel_positions{size} on {dev.type}: {RIG_FRAMES} frames, "
           f"then ([], []); occupied voxels {n_occ}; launches "
           f"{seam_launches}")
    t0 = time.perf_counter()
    outs_cpu, end_cpu, _, model_cpu = seam_calls(
        api, data, models, frames, size, "cpu", model_kw)
    expect(outs == outs_cpu and end_cpu == ([], []),
           f"positions and colours lists equal on {dev.type} and on the CPU "
           f"(plain versions, {time.perf_counter() - t0:.1f} s)")
    pts = np.asarray(outs[0][0])
    expect(pts.shape == (n_occ[0], 3) and bool(np.isfinite(pts).all()),
           "positions are finite (M, 3)")

    # the seam's split: the step, the compaction, the lists
    split = {"step": [], "compact": [], "tolist": []}
    for fr in frames:
        t0 = time.perf_counter()
        occ, col = model.process_frame_fast(fr)
        sync(torch, dev)
        t1 = time.perf_counter()
        pos, rgb = carve_ops.compact_voxels(occ, col, model.grid,
                                            model.rig.scaling_factor)
        t2 = time.perf_counter()
        pos.tolist(), rgb.tolist()
        t3 = time.perf_counter()
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(v * 1e3)
    call_ms = float(np.median(ms[1:]))
    split_ms = {k: float(np.median(v)) for k, v in split.items()}
    print(f"  set_voxel_positions {call_ms:.3f} ms per call (median of "
          f"{len(ms) - 1}; the first, which makes the model, {ms[0]:.1f} ms); "
          f"split by parts: {split_ms}")

    # the cameras as the viewer sees them: the host f64 values
    cams = [CameraParams.from_arrays(*c) for c in rig_cameras(image_hw)]
    pos_want, pal_want = reconstruction.get_cam_positions(cams, 115.0)
    pos_got, pal_got = api.get_cam_positions()
    rot_want = reconstruction.get_cam_rotation_matrices(cams)
    rot_got = api.get_cam_rotation_matrices()
    expect(np.array_equal(np.array(pos_got), np.array(pos_want))
           and pal_got == pal_want
           and all(np.array_equal(a, b) for a, b in zip(rot_got, rot_want)),
           "get_cam_positions and get_cam_rotation_matrices equal to the "
           f"host f64 values; centres {np.round(pos_got, 3).tolist()}")

    # a grid that is not divisible by 8·sup: the table step
    n_tab = 3
    for k in kernels:
        k.launches = 0
    outs_t, _, _, model_t = seam_calls(api, data, models, frames[:n_tab],
                                       size_tables, dev, model_kw)
    sync(torch, dev)
    tab_launches = {k.source.stem: k.launches for k in kernels}
    outs_tc, _, _, _ = seam_calls(api, data, models, frames[:n_tab],
                                  size_tables, "cpu", model_kw)
    expect(model_t._ensure_btab() is None and outs_t == outs_tc
           and min(len(p) for p, _ in outs_t) > 0
           and (dev.type == "cpu" or tab_launches["carve_blocked"] == 0
                and tab_launches["ccl_combined"] >= n_tab),
           f"set_voxel_positions{size_tables} takes the table step; lists "
           f"equal on {dev.type} and on the CPU over {n_tab} frames; "
           f"occupied voxels {[len(p) for p, _ in outs_t]}; launches "
           f"{tab_launches}")

    # the three cleanup routes of the mask stage on one rig frame
    route_names = ("device", "host", "device-xla")
    masks, route_ms = {}, {}
    for route in route_names:
        t0 = time.perf_counter()
        masks[route] = model.masks(frames[2], ccl_backend=route).cpu()
        route_ms[route] = (time.perf_counter() - t0) * 1e3
    expect(all(torch.equal(masks[route], masks["device"])
               and torch.equal(model_cpu.masks(frames[2], ccl_backend=route),
                               masks["device"]) for route in route_names)
           and int((masks["device"] > 0).sum()) > 0,
           f"masks(ccl_backend=device, host, device-xla) equal on "
           f"{dev.type} and on the CPU; ms on {dev.type} {route_ms}")

    # the projection-table cache on the second size's grid: the first model
    # builds, the second loads
    cache = f"{build_root}/seam_tables_{H}x{W}"
    shutil.rmtree(cache, ignore_errors=True)

    def cached_tables():
        m = VisualHull(model_t.cameras, model_t.grid, model_t.rig,
                       cache_dir=cache, device=dev)
        t0 = time.perf_counter()
        tables = m.tables
        sync(torch, dev)
        return tables, (time.perf_counter() - t0) * 1e3

    built, build_ms = cached_tables()
    files = sorted(os.listdir(cache))
    loaded, load_ms = cached_tables()
    expect(len(files) == 1 and sorted(os.listdir(cache)) == files
           and torch.equal(built.valid, loaded.valid)
           and torch.equal(built.lin_idx, loaded.lin_idx),
           f"VisualHull(cache_dir=): the first model built {files[0]} in "
           f"{build_ms:.0f} ms, the second loaded the same tables in "
           f"{load_ms:.0f} ms")
    api.configure(None, None, None)
    rig = SimpleNamespace(model=model, model_cpu=model_cpu, frames=frames,
                          models=models)
    return rig, {"size": list(size), "frames": RIG_FRAMES,
            "set_voxel_positions_ms": call_ms, "first_call_ms": ms[0],
            "split_ms": split_ms, "occupied_voxels": n_occ,
            "launches": seam_launches, "tables_size": list(size_tables),
            "tables_launches": tab_launches,
            "masks_route_ms": route_ms,
            "table_cache_ms": {"build": build_ms, "load": load_ms}}


SURFACE_CAPACITY = 32768  # the surface entry points' default
# their default rule: what skimage's Lewiner MC33 resolves on a binary volume
SURFACE_PAIR = ("cubes", "join")
SURFACE_RIG_FRAMES = (0, 4)  # phase 14's frames held card vs CPU
# ~2 ms: ``surface_program`` enqueues some 60 launches, more than the
# default spin covers
SURFACE_SPIN_CYCLES = 4_000_000


def three_cubes():
    """(40, 8, 8) bool: three 2-voxel cubes far apart along x, whose active
    cells (at most 128) lie in at least three 128-cell blocks."""
    vol = np.zeros((40, 8, 8), bool)
    for x0 in (2, 16, 30):
        vol[x0:x0 + 2, 2:4, 2:4] = True
    return vol


def surface_phase(torch, dev, kernels, flush, model, model_cpu, frame0,
                  occ_c, col_c, seq, rig, step_ms, keep=None):
    """Phase 16: the surface path (see ``run``) on ``model`` (the seeded
    synthetic rig) and ``rig.model`` (phase 14's rig), against the CPU
    occupancies ``occ_c``/``col_c`` of ``frame0`` and those of the rig
    frames; ``step_ms`` is phase 5's.  Keeps the rig frame's triangles in
    ``keep`` (for phase 24).  Returns its report."""
    from scipy import ndimage

    from vbr_tpu_torch.models.visual_hull import (
        _decode_surface_wire, _encode_surface_wire, _start_download, _wait)
    from vbr_tpu_torch.ops import marching_cubes as mc
    from vbr_tpu_torch.ops.texturing import TexturingTables

    grid, cap = model.grid, SURFACE_CAPACITY
    origin, spacing = model._world_frame()

    def reset_counts():
        for k in kernels:
            k.launches = 0

    def k1_k2_launches():
        return {k.source.stem: k.launches for k in kernels[:2]}

    def raw_surface(m, fr, pair=SURFACE_PAIR):
        """The surface step's device outputs → (verts, valid, n_active,
        overflow)."""
        occ_s, _, ovf = m._step(m._frames(fr), m._carve_kernel("auto"))
        return (*mc.surface_program(occ_s.reshape(m.grid.shape),
                                    algorithm=pair[0], ambiguity=pair[1],
                                    capacity=cap), ovf)

    def wire_of(m, fr):
        """The surface step's one-buffer wire."""
        occ_s, _, ovf = m._step(m._frames(fr), m._carve_kernel("auto"))
        return _encode_surface_wire(occ_s, ovf, m.grid.shape, cap)

    def cpu_surface(occ_cpu, pair):
        """The CPU side on occupancy carved on the CPU: ``surface_program``,
        or where that reports more than the capacity, the host redo's
        ``extract_mesh`` → (world triangles, n_reported)."""
        verts, valid, n = mc.surface_program(
            occ_cpu.reshape(grid.shape), algorithm=pair[0],
            ambiguity=pair[1], capacity=cap)
        if int(n) > cap:
            return mc.extract_mesh(occ_cpu.reshape(grid.shape), origin,
                                   spacing, algorithm=pair[0],
                                   ambiguity=pair[1])[0], int(n)
        return mc.world_triangles(verts, valid, origin, spacing), int(n)

    def hold(m, fr, occ_want, col_want, what, pair=SURFACE_PAIR):
        reset_counts()
        tris, occ, col = m.process_frame_surface(fr, *pair, capacity=cap)
        sync(torch, dev)
        launches = k1_k2_launches()
        raw = raw_surface(m, fr, pair)
        n_dev, ccl_redo = int(raw[2]), bool(raw[3].any())
        redo = ccl_redo or n_dev > cap
        want, n_rep = cpu_surface(occ_want, pair)
        act = mc.active_cells_mask(occ_want.reshape(grid.shape)).reshape(-1)
        pad = (-act.numel()) % mc._COMPACT_BLOCK
        blocks = int(torch.cat([act, act.new_zeros(pad)]).reshape(
            -1, mc._COMPACT_BLOCK).any(1).sum())
        # a frame redone for a component-table overflow takes its colours
        # from the table path, which also colours voxels off the hull
        on = occ_want if ccl_redo else slice(None)
        expect(np.array_equal(tris, want) and len(tris) > 0
               and torch.equal(occ.cpu(), occ_want)
               and torch.equal(col.cpu()[on], col_want[on]) and n_dev == n_rep
               and (dev.type == "cpu" or min(launches.values()) >= 1),
               f"process_frame_surface{pair} on {what}: triangles, "
               f"occupancy and colours bit-equal on {dev.type} and on the "
               f"CPU; n_active {int(act.sum())} in {blocks} blocks of "
               f"{mc._COMPACT_BLOCK} cells (reported {n_dev}), triangles "
               f"{len(tris)}, redo {redo}; launches {launches}")
        return {"tris": tris, "occ": occ, "n_active": int(act.sum()),
                "blocks": blocks, "n_reported": n_dev, "redo": redo,
                "triangles": len(tris)}

    # the two inputs, card against CPU
    held = {"synthetic": hold(model, frame0, occ_c, col_c,
                              "the synthetic frame")}
    rig_cpu = {}
    for k in SURFACE_RIG_FRAMES:
        fr = rig.frames[k]
        t0 = time.perf_counter()
        rig_cpu[k] = rig.model_cpu.process_frame_fast(fr)
        held[f"rig {k}"] = hold(
            rig.model, fr, *rig_cpu[k],
            f"rig frame {k} (CPU carve {time.perf_counter() - t0:.1f} s)")
    k0 = SURFACE_RIG_FRAMES[0]
    rig0, fr0 = held[f"rig {k0}"], rig.frames[k0]
    if keep is not None:
        keep["rig_tris"] = rig0["tris"]

    # times: the step on both inputs, then on the rig frame the program
    # alone, the download and the placement
    def step_on(m, fr, surface=True):
        def step():
            (m.process_frame_surface if surface else m.process_frame_fast)(fr)
            sync(torch, dev)
        return step

    surf_ms = {"synthetic": timed_ms(step_on(model, frame0), torch, dev,
                                     reps=10),
               "rig": timed_ms(step_on(rig.model, fr0), torch, dev, reps=10)}
    fast_rig_ms = timed_ms(step_on(rig.model, fr0, surface=False), torch,
                           dev, reps=10)
    print(f"  process_frame_surface {surf_ms['synthetic']:.3f} ms/frame on "
          f"the synthetic frame (redo {held['synthetic']['redo']}), "
          f"{surf_ms['rig']:.3f} on rig frame {k0} (redo {rig0['redo']}), "
          f"medians of 10; process_frame_fast {step_ms:.3f} and "
          f"{fast_rig_ms:.3f}")
    vol_d = rig0["occ"].reshape(grid.shape)
    T = mc._mc_maxt(SURFACE_PAIR[1])

    def program():
        return mc.surface_program(vol_d, algorithm=SURFACE_PAIR[0],
                                  ambiguity=SURFACE_PAIR[1], capacity=cap)

    sp_ms = timed_ms(program, torch, dev, flush=flush,
                     spin_cycles=SURFACE_SPIN_CYCLES)
    n_cells = int(np.prod([n - 1 for n in grid.shape]))
    # the volume read once; triangles, their flags and the count written
    # once; per cell 8 shifted adds and the two active tests
    sp_bytes = grid.num_voxels + cap * T * (9 * 4 + 1) + 4
    sp_bound, sp_bound_by = bound(sp_bytes, n_cells * 18)
    print(f"  surface_program {sp_ms:.4f} ms (device), bound "
          f"{sp_bound:.5f} ms ({sp_bound_by}: {sp_bytes} B)")
    out = raw_surface(rig.model, fr0)
    sync(torch, dev)
    dl, place = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        host, ready = _start_download(out)
        _wait(ready)
        t1 = time.perf_counter()
        mc.world_triangles(host[0], host[1], origin, spacing)
        place.append((time.perf_counter() - t1) * 1e3)
        dl.append((t1 - t0) * 1e3)
    dl_bytes = sum(t.numel() * t.element_size() for t in out)
    dl_ms, place_ms = float(np.median(dl)), float(np.median(place))
    print(f"  download of {dl_bytes} B into pinned memory {dl_ms:.3f} ms, "
          f"world_triangles on the host {place_ms:.3f} ms (medians of 10)")
    profiles = {}
    if dev.type == "cuda":
        def program_sync():
            program()
            sync(torch, dev)
        sp_host_ms = timed_ms(program_sync, torch, dev, reps=10)
        profiles["surface_program"] = profile_step(
            torch, program_sync, sp_host_ms,
            f"  profile of 4 surface programs ({sp_host_ms:.3f} ms each to "
            "a synchronised result):", top=8)
        profiles["fast"] = profile_step(
            torch, step_on(rig.model, fr0, surface=False), fast_rig_ms,
            f"  profile of 4 process_frame_fast steps on rig frame {k0}:",
            top=5)
        profiles["surface"] = profile_step(
            torch, step_on(rig.model, fr0), surf_ms["rig"],
            f"  profile of 4 process_frame_surface steps on rig frame {k0}:")
        if profiles["fast"] and profiles["surface"]:
            a, b = profiles["fast"], profiles["surface"]
            print(f"  the surface adds {b['device_ops_per_frame'] - a['device_ops_per_frame']:.0f}"
                  f" device ops and {b['device_busy_ms_per_frame'] - a['device_busy_ms_per_frame']:.3f}"
                  " device ms per frame")

    # the wire's host tail (the native emission) on the rig frame
    wire, ready = _start_download((wire_of(rig.model, fr0),))
    _wait(ready)
    _, n_w, idx_w, cfg_w, _ = _decode_surface_wire(wire[0], cap,
                                                   grid.num_voxels)
    tail = []
    for _ in range(10):
        t0 = time.perf_counter()
        tris_w = mc.triangles_from_wire(idx_w, cfg_w, n_w, grid.shape,
                                        origin, spacing)
        tail.append((time.perf_counter() - t0) * 1e3)
    wire_tail_ms = float(np.median(tail))
    expect(np.array_equal(tris_w, rig0["tris"]),
           f"the wire's host tail gives rig frame {k0}'s triangles in "
           f"{wire_tail_ms:.3f} ms (median of 10; wire of "
           f"{wire[0].numel()} B)")

    # stream_surface over the stream's frames and over the rig's, both
    # transfers, each frame equal to process_frame_surface
    stream = {}
    for name, m, frames in (("stream", model, seq),
                            ("rig", rig.model, list(rig.frames))):
        refs = [m.process_frame_surface(fr) for fr in frames]
        redone = 0  # frames over the capacity or a component table
        for fr in frames:
            any_ovf, n_rep = wire_of(m, fr)[:8].view(torch.int32).tolist()
            redone += bool(any_ovf) or n_rep > cap
        for transfer in ("full", "wire"):
            list(m.stream_surface(iter(frames[:2]), transfer=transfer))
            sync(torch, dev)
            reset_counts()
            stamps, outs = [time.perf_counter()], []
            for o in m.stream_surface(iter(frames), transfer=transfer):
                outs.append(o)
                stamps.append(time.perf_counter())
            sync(torch, dev)
            launches = k1_k2_launches()
            for f, ((tris, occ), (t_ref, o_ref, _)) in enumerate(
                    zip(outs, refs)):
                if isinstance(occ, torch.Tensor):
                    occ = occ.cpu().numpy()
                if not (np.array_equal(tris, t_ref)
                        and np.array_equal(occ, o_ref.cpu().numpy())):
                    raise Failed(f"stream_surface(transfer={transfer!r}) on "
                                 f"the {name}'s frame {f} differs from "
                                 "process_frame_surface")
            ms = (stamps[-1] - stamps[0]) * 1e3 / len(frames)
            expect(len(outs) == len(frames) and (dev.type == "cpu" or min(
                launches.values()) >= len(frames)),
                   f"stream_surface(transfer={transfer!r}) on the {name}'s "
                   f"{len(frames)} frames equal to process_frame_surface; "
                   f"{ms:.3f} ms/frame (mean), {redone} frames redone "
                   f"on the host; launches {launches}")
            stream[f"{name} {transfer}"] = {
                "ms_per_frame": ms, "frames": len(frames),
                "redone": redone,
                "per_frame_ms": (np.diff(stamps) * 1e3).tolist(),
                "launches": launches}

    # held, not timed, on the rig frame (the device path)
    occ_r0, col_r0 = rig_cpu[k0]
    for pair in (("tetrahedra", "separate"), ("cubes", "separate")):
        hold(rig.model, fr0, occ_r0, col_r0, f"rig frame {k0}", pair)
    redo_cap = min(1024, rig0["n_active"] - 1)
    tris_r, occ_r, col_r = rig.model.process_frame_surface(
        fr0, capacity=redo_cap)
    expect(rig0["n_active"] > redo_cap and np.array_equal(tris_r, rig0["tris"])
           and torch.equal(occ_r.cpu(), occ_r0)
           and torch.equal(col_r.cpu(), col_r0),
           f"extract_mesh on the step's occupancy gives the same triangles, "
           f"occupancy and colours at capacity {redo_cap} < "
           f"{rig0['n_active']} active cells")
    tris_e, n_e = rig.model.extract_surface(fr0)
    expect(n_e == rig0["triangles"] and np.array_equal(tris_e, rig0["tris"]),
           "extract_surface equals process_frame_surface")
    cubes = three_cubes()
    got = mc.surface_program(torch.from_numpy(cubes).to(dev), capacity=128,
                             block_capacity=2)
    want = mc.surface_program(torch.from_numpy(cubes), capacity=128,
                              block_capacity=2)
    n_true = int(mc.active_cells_mask(torch.from_numpy(cubes)).sum())
    expect(all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
           and int(got[2]) > 128 >= n_true,
           f"surface_program(block_capacity=2) on three separated cubes: "
           f"n_reported {int(got[2])} > capacity 128 ({n_true} active "
           f"cells), raw outputs equal on {dev.type} and on the CPU")
    masks0 = model.masks(frame0)
    t0 = time.perf_counter()
    tex = model.textured_frame(frame0, masks0)
    sync(torch, dev)
    tex_s = time.perf_counter() - t0
    t = model._tex_tables  # the f64 host build, once
    model_cpu._tex_tables = TexturingTables(t.valid.cpu(), t.lin_idx.cpu(),
                                            t.depth.cpu(), t.image_hw)
    tex_c = model_cpu.textured_frame(frame0, masks0.cpu())
    used = sorted(set(tex[2].cpu().numpy()[occ_c.numpy()].tolist()))
    expect(all(torch.equal(a.cpu(), b) for a, b in zip(tex, tex_c)),
           f"textured_frame: occupancy, colours and cam_choice equal on "
           f"{dev.type} and on the CPU; cameras chosen {used}; first call "
           f"(tables included) {tex_s:.2f} s")
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            program()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync(torch, dev)
        print("  ok: surface_program queued with no host synchronisation "
              "(torch.cuda.set_sync_debug_mode('error'))")
    return {"capacity": cap, "pair": list(SURFACE_PAIR),
            "held": {k: {n: v[n] for n in ("n_active", "blocks",
                                           "n_reported", "redo",
                                           "triangles")}
                     for k, v in held.items()},
            "process_frame_surface_ms": surf_ms,
            "process_frame_fast_ms": {"synthetic": step_ms,
                                      "rig": fast_rig_ms},
            "surface_program": {"ms": sp_ms, "bound_ms": sp_bound,
                                "bound_by": sp_bound_by, "bytes": sp_bytes},
            "download": {"bytes": dl_bytes, "ms": dl_ms},
            "world_triangles_ms": place_ms,
            "wire_tail_ms": wire_tail_ms,
            "stream_surface": stream,
            "profiles": profiles}


ROI_HW = (320, 224)  # ``stream_viewer``'s default window
INGESTS = ("bgr", "yuv420", "yuv420_roi")
VIEWER_DEPTH = 3  # ``stream_viewer``'s default frames in flight


def viewer_phase(torch, dev, kernels, flush, model, model_cpu, fo, rig,
                 roi_hw):
    """Phase 17: the thin-link viewer stream (see the docstring) on the rig
    of phase 14 (``rig``), phase 7's overflow frame ``fo`` on the synthetic
    model; returns its report."""
    from vbr_tpu_torch import native
    from scipy import ndimage

    from vbr_tpu_torch.models.visual_hull import (
        _decode_surface_wire, _encode_surface_wire, _start_download, _wait)
    from vbr_tpu_torch.ops import carve_blocked as cb
    from vbr_tpu_torch.ops import color as color_ops
    from vbr_tpu_torch.ops import marching_cubes as mc

    m, mc_cpu, frames = rig.model, rig.model_cpu, list(rig.frames)
    nvox = m.grid.num_voxels

    def reset_counts():
        for k in kernels:
            k.launches = 0

    def k1_k2_launches():
        return {k.source.stem: k.launches for k in kernels[:2]}

    def same_arrays(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    def host_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    # the modes a tracker gives these frames, and what each uploads
    tracker = m._roi_tracker(roi_hw)
    modes = [m._ingest_prepare("yuv420_roi", tracker, fr)[0] for fr in frames]
    C, (H, W) = len(m.cameras), m.image_hw
    upload_bytes = {"bgr": C * H * W * 3, "yuv420": C * H * 3 // 2 * W,
                    "yuv420_roi": C * roi_hw[0] * 3 // 2 * roi_hw[1]}
    roi_upload = float(np.mean([upload_bytes[md] for md in modes]))
    wire_bytes = int(m._step(m._frames(frames[0]), "blocked",
                             "packed").numel())
    print(f"  upload bytes per frame: {upload_bytes}; the tracker sends "
          f"{modes.count('yuv420')} of {len(frames)} frames to full-frame "
          f"yuv420 (modes {modes}), so yuv420_roi uploads {roi_upload:.0f} B "
          f"per frame on these frames; wire {wire_bytes} B per frame")

    # stream_viewer, each ingest: card vs CPU, the launches, ms/frame
    report = {"roi_hw": list(roi_hw), "upload_bytes": upload_bytes,
              "roi_upload_bytes_mean": roi_upload, "roi_modes": modes,
              "wire_bytes": wire_bytes, "stream_viewer": {}}
    blocked = [m.process_frame_fast(fr, layout="blocked") for fr in frames]
    lossless = [cb.compact_voxels_blocked(occ, col, m._btab, m.grid,
                                          m.rig.scaling_factor)
                for occ, col in blocked]
    # each frame's wire overflow word, per ingest: the frames a stream
    # redoes from their BGR frames
    report["redone"] = {}
    for ingest in INGESTS:
        tr = m._roi_tracker(roi_hw)
        words = []
        for fr in frames:
            mode, upload, off = m._ingest_prepare(ingest, tr, fr)
            words.append(cb.decode_wire(
                m._step(m._frames(upload), "blocked", "packed", mode, off),
                total_voxels=nvox)[0])
        report["redone"][ingest] = words
    print(f"  wire overflow word per frame (1: the frame is redone from its "
          f"BGR frames): {report['redone']}")
    # why: raw foreground components per camera on rig frame 2 (the device
    # cleanup's table holds kf = 512 of them, and 128 background ones)
    comps = {}
    for ingest in INGESTS:
        tr = m._roi_tracker(roi_hw)
        tr.update(frames[1])
        mode, upload, off = m._ingest_prepare(ingest, tr, frames[2])
        raw, _ = m._stage.head(m._frames(upload), mode, off)
        raw = raw.cpu().numpy() > 0
        comps[ingest] = [[ndimage.label(ph, structure=np.ones((3, 3)))[1]
                          for ph in (r, ~r)] for r in raw]
    print(f"  rig frame 2: [foreground, background] components of the raw "
          f"masks per camera: {comps}")
    report["raw_components"] = comps
    for ingest in INGESTS:
        list(m.stream_viewer(iter(frames[:2]), ingest=ingest,
                             roi_hw=roi_hw))  # warm-up
        sync(torch, dev)
        reset_counts()
        stamps, outs = [time.perf_counter()], []
        for out in m.stream_viewer(iter(frames), ingest=ingest,
                                   roi_hw=roi_hw):
            outs.append(out)
            stamps.append(time.perf_counter())
        sync(torch, dev)
        launches = k1_k2_launches()
        ms = (stamps[-1] - stamps[0]) * 1e3 / len(frames)
        t0 = time.perf_counter()
        want = list(mc_cpu.stream_viewer(iter(frames), ingest=ingest,
                                         roi_hw=roi_hw))
        cpu_s = time.perf_counter() - t0
        expect(len(outs) == len(frames)
               and all(same_arrays(a, b) for a, b in zip(outs, want))
               and all(len(p) > 0 and p.dtype == np.float32 for p, _ in outs)
               and (dev.type == "cpu"
                    or min(launches.values()) >= len(frames)),
               f"stream_viewer(ingest={ingest!r}) on the rig's {len(frames)} "
               f"frames: (positions, rgb) bit-equal on {dev.type} and on the "
               f"CPU (CPU {cpu_s:.1f} s); {ms:.3f} ms/frame (mean); launches "
               f"{launches}; occupied voxels {[len(p) for p, _ in outs]}")
        if ingest == "bgr":
            expect(all(same_arrays(a, b) for a, b in zip(outs, lossless)),
                   "stream_viewer(ingest='bgr') equals compact_voxels_blocked"
                   " of process_frame_fast(layout='blocked'): the wire is "
                   "lossless")
        report["stream_viewer"][ingest] = {
            "ms_per_frame": ms,
            "per_frame_ms": (np.diff(stamps) * 1e3).tolist(),
            "launches": launches, "occupied": [len(p) for p, _ in outs]}

    # the bgr stream's parts on rig frame 0: the pack on the device, the
    # download, the host unpack, beside the uncompressed compaction
    occ_b, col_b = blocked[0]
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)

    def pack():
        return cb.encode_wire(*cb.pack_blocked_outputs(occ_b, col_b)[:5],
                              no_ovf)

    pack_ms = timed_ms(pack, torch, dev, flush=flush,
                       spin_cycles=SURFACE_SPIN_CYCLES)
    wire0 = pack()

    def download():
        (h,), ready = _start_download((wire0,))
        _wait(ready)
        return h

    dl_ms, wire_h = host_ms(download)
    unpack_ms, arrays = host_ms(lambda: cb.viewer_arrays_from_packed(
        *(lambda d: (d[4], d[3], d[1], d[2], d[5]))(
            cb.decode_wire(wire_h, total_voxels=nvox)),
        m._btab, m.grid, m.rig.scaling_factor))
    compact_ms, _ = host_ms(lambda: cb.compact_voxels_blocked(
        occ_b, col_b, m._btab, m.grid, m.rig.scaling_factor))
    expect(same_arrays(arrays, lossless[0]),
           f"the wire's parts on rig frame 0: pack {pack_ms:.4f} ms on "
           f"{dev.type}, download {dl_ms:.3f} ms, host unpack {unpack_ms:.3f}"
           f" ms, against compact_voxels_blocked {compact_ms:.3f} ms "
           "(medians)")
    report["parts_ms"] = {"pack": pack_ms, "download": dl_ms,
                          "unpack": unpack_ms,
                          "compact_voxels_blocked": compact_ms}
    if dev.type == "cuda":
        def viewer4():
            list(m.stream_viewer(iter(frames[:4])))
            sync(torch, dev)
        report["profile"] = profile_step(
            torch, viewer4, report["stream_viewer"]["bgr"]["ms_per_frame"],
            "  profile of stream_viewer(ingest='bgr') over 4 rig frames:",
            frames=4, frames_per_step=4, top=8)

    # the guard, card vs CPU
    report["validate"] = {}
    for ingest in INGESTS[1:]:
        got = m.validate_reduced_ingest(frames[2], ingest=ingest,
                                        roi_hw=roi_hw)
        want = mc_cpu.validate_reduced_ingest(frames[2], ingest=ingest,
                                              roi_hw=roi_hw)
        expect(got == want and got["occ_exact"] > 0,
               f"validate_reduced_ingest(ingest={ingest!r}) on rig frame 2 "
               f"equal on {dev.type} and on the CPU: mask_iou_min "
               f"{got['mask_iou_min']}, occ_diff_voxels "
               f"{got['occ_diff_voxels']} of {got['occ_exact']}, "
               f"max_channel_err {got['max_channel_err']}")
        report["validate"][ingest] = got

    # one rig frame's wire of each upload, byte for byte (the device path
    # whatever its overflow word); a forced pack overflow; phase 7's
    # component overflow
    tr = m._roi_tracker(roi_hw)
    tr.update(frames[0])
    for ingest in INGESTS:
        mode, upload, off = m._ingest_prepare(ingest, tr, frames[1])
        wire = m._step(m._frames(upload), "blocked", "packed", mode, off)
        wire_c = mc_cpu._step(mc_cpu._frames(upload), "blocked", "packed",
                              mode, off)
        head = cb.decode_wire(wire, total_voxels=nvox)[:3]
        expect(torch.equal(wire.cpu(), wire_c),
               f"rig frame 1's wire from a {mode!r} upload ({wire.numel()} "
               f"B; overflow word, occupied sub-blocks, voxels {head}) "
               f"byte-equal on {dev.type} and on the CPU")
    wire = m._step(m._frames(frames[0]), "blocked", "packed")
    n_blocks = cb.decode_wire(wire, total_voxels=nvox)[1]
    k_default = cb.WIRE_K_BLOCKS
    cb.WIRE_K_BLOCKS = n_blocks - 1
    try:
        forced = cb.decode_wire(
            m._step(m._frames(frames[0]), "blocked", "packed"),
            total_voxels=nvox)[0]
        got = list(m.stream_viewer(iter(frames[:2])))
        want = list(mc_cpu.stream_viewer(iter(frames[:2])))
    finally:
        cb.WIRE_K_BLOCKS = k_default
    expect(forced == 1 and all(same_arrays(a, b) for a, b in zip(got, want))
           and all(same_arrays(a, b) for a, b in zip(got, lossless)),
           f"a wire of {n_blocks - 1} sub-blocks overflows on rig frame 0; "
           "stream_viewer takes the exact fallback, equal on the card and "
           "on the CPU and to the lossless arrays")
    ovf_word = cb.decode_wire(
        model._step(model._frames(fo), "blocked", "packed"),
        total_voxels=model.grid.num_voxels)[0]
    got = list(model.stream_viewer(iter([fo])))
    want = list(model_cpu.stream_viewer(iter([fo])))
    expect(ovf_word == 1 and same_arrays(got[0], want[0]) and len(got[0][0]),
           "phase 7's overflow frame sets the wire's overflow word; "
           f"stream_viewer redoes it exactly, equal on {dev.type} and on the "
           "CPU")

    # stream_surface with the reduced uploads, both transfers
    report["stream_surface"] = {}
    for ingest in INGESTS[1:]:
        t0 = time.perf_counter()
        want = list(mc_cpu.stream_surface(iter(frames), ingest=ingest,
                                          roi_hw=roi_hw))
        cpu_s = time.perf_counter() - t0
        for transfer in ("full", "wire"):
            reset_counts()
            t0 = time.perf_counter()
            got = list(m.stream_surface(iter(frames), transfer=transfer,
                                        ingest=ingest, roi_hw=roi_hw))
            sync(torch, dev)
            ms = (time.perf_counter() - t0) * 1e3 / len(frames)
            launches = k1_k2_launches()
            ok = len(got) == len(frames)
            for (tris, occ), (tris_c, occ_c) in zip(got, want):
                occ = occ.cpu().numpy() if hasattr(occ, "cpu") else occ
                ok &= (np.array_equal(tris, tris_c) and len(tris) > 0
                       and np.array_equal(occ, occ_c.numpy()))
            expect(ok and (dev.type == "cpu"
                           or min(launches.values()) >= len(frames)),
                   f"stream_surface(ingest={ingest!r}, transfer="
                   f"{transfer!r}) on the rig's {len(frames)} frames equal "
                   f"on {dev.type} and on the CPU (CPU {cpu_s:.1f} s); "
                   f"{ms:.3f} ms/frame (mean, first call); launches "
                   f"{launches}")
            report["stream_surface"][f"{ingest} {transfer}"] = {
                "ms_per_frame": ms, "launches": launches}

    # the native host tails against their numpy references
    stack = np.stack(frames)
    packs = [native.yuv420_pack(fr) for fr in frames]
    expect(all(np.array_equal(p, color_ops._bgr_to_yuv420_numpy(fr))
               for p, fr in zip(packs, frames)),
           f"native.yuv420_pack byte-equal to the numpy pack on the rig's "
           f"{len(frames)} frames")
    pack_ms, _ = host_ms(lambda: native.yuv420_pack(stack[0]))
    pack_np_ms, _ = host_ms(lambda: color_ops._bgr_to_yuv420_numpy(stack[0]))
    track_ms, _ = host_ms(lambda: tracker.update(stack[1]))
    crop_ms, _ = host_ms(lambda: color_ops.bgr_to_yuv420_host(
        tracker.crop(stack[1])))
    occ0, _, ovf0 = m._step(m._frames(frames[0]), m._carve_kernel("auto"))
    (buf,), ready = _start_download((_encode_surface_wire(
        occ0, ovf0, m.grid.shape, SURFACE_CAPACITY),))
    _wait(ready)
    _, n_w, idx_w, cfg_w, _ = _decode_surface_wire(buf, SURFACE_CAPACITY,
                                                   nvox)
    origin, spacing = m._world_frame()
    tv, tvalid = mc._binary_emit_table(*SURFACE_PAIR, 0.5)
    gs = m.grid.shape
    emit_ms, tris = host_ms(lambda: mc.triangles_from_wire(
        idx_w, cfg_w, n_w, gs, origin, spacing, *SURFACE_PAIR))
    emit_np_ms, tris_np = host_ms(lambda: mc._triangles_from_wire_numpy(
        idx_w, cfg_w, n_w, tv, tvalid, gs[1] - 1, gs[2] - 1, origin,
        spacing))
    expect(len(tris) > 0 and tris.view(np.uint32).tobytes()
           == tris_np.view(np.uint32).tobytes(),
           f"native.mc_emit bit-equal to the numpy tail on rig frame 0's "
           f"surface wire ({n_w} active cells, {len(tris)} triangles)")
    report["host_ms"] = {"yuv420_pack": pack_ms, "yuv420_pack_numpy":
                         pack_np_ms, "tracker_update": track_ms,
                         "roi_crop_and_pack": crop_ms, "mc_emit": emit_ms,
                         "mc_emit_numpy": emit_np_ms}
    print(f"  host ms (medians of 10): {report['host_ms']}")

    # a viewer frame queued with no host synchronisation, up to its download
    if dev.type == "cuda":
        tr = m._roi_tracker(roi_hw)
        tr.update(frames[0])
        for ingest, t in (("bgr", None), ("yuv420", None),
                          ("yuv420_roi", tr)):
            torch.cuda.set_sync_debug_mode("error")
            try:
                mode, upload, off = m._ingest_prepare(ingest, t, frames[1])
                _start_download((m._step(m._frames(upload), "blocked",
                                         "packed", mode, off),))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sync(torch, dev)
            print(f"  ok: a stream_viewer frame (ingest={ingest!r}, mode "
                  f"{mode!r}) queued up to its download with no host "
                  "synchronisation (torch.cuda.set_sync_debug_mode('error'))")
    return report


LARGE_EDGES = (256, 512)  # phase 18: the rig's steps; the 8-camera carve
STRETCH_CAMERAS = 8
STRETCH_SPOT = 1 << 20  # voxels per camera re-projected in f64 at 512³
TABLE_FIELDS = ("pk", "lcc", "vorig", "uorig", "allv", "ry", "rx")


def timed_s(fn, torch, dev):
    """(fn(), host seconds to a synchronised result)."""
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


def reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gb(torch, dev):
    """Peak device memory since :func:`reset_peak` (GB), None on the CPU."""
    return (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)


def tables_equal(torch, a, b):
    """Two ``BlockTables``, on any devices, equal in every field."""
    return (all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
                for f in TABLE_FIELDS)
            and (a.WH, a.WC, a.Hp, a.Wc, a.n_fcells_hw)
            == (b.WH, b.WC, b.Hp, b.Wc, b.n_fcells_hw))


def tables_on_cpu(btab):
    return dataclasses.replace(btab, **{f: getattr(btab, f).cpu()
                                        for f in TABLE_FIELDS})


def suspicious_counts(torch, carve, cams, grid, image_hw, dev):
    """Per camera, the voxels that the device builds re-project in f64."""
    xs, ys, zs = (torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in grid.axis_ranges())
    planes = carve._slab_planes(grid)
    return [sum(int(carve._proj_suspicion_chunk(
        xs[x0:x0 + planes], ys, zs, *carve._camera_f32(cp, dev),
        image_hw)[3].sum()) for x0 in range(0, grid.nx, planes))
        for cp in cams]


def f64_words(cb, carve, cams, grid, image_hw, gidx):
    """(len(gidx), C) packed words of the canonical voxels ``gidx`` from the
    f64 host projection."""
    axes = grid.axis_ranges()
    out = []
    for cp in cams:
        iy, ix, valid = carve._exact_f64(cp, axes, gidx, image_hw)
        out.append(cb._pk_words(np.where(valid, iy, cb.INVALID_ROW), ix))
    return np.stack(out, axis=1)


def large_grid_phase(torch, dev, kernels, flush, model, rig, image_hw,
                     edges=LARGE_EDGES, keep=None):
    """Phase 18: large grids (see ``run``) on ``model`` (the synthetic rig
    at phase 3's grid), ``rig`` (phase 14's models and frames) and a
    synthetic 8-camera rig; ``edges`` are the grid edges of the rig's
    steps (256) and of the 8-camera carve (512).  With a dict ``keep``, the
    8-camera carve's tables, masks, colour frame and view threshold stay
    in it (for phase 21).  Returns its report."""
    from vbr_tpu_torch.models.visual_hull import VisualHull
    from vbr_tpu_torch.ops import carve
    from vbr_tpu_torch.ops import carve_blocked as cb
    from vbr_tpu_torch.ops import marching_cubes as mc
    from vbr_tpu_torch.pipelines.reconstruction import Reconstructor
    from vbr_tpu_torch.utils.config import GridConfig, RigConfig
    from vbr_tpu_torch.utils.synthetic import synthetic_rig

    H, W = image_hw
    edge, stretch = edges
    report = {}

    def launches(names=("carve_blocked", "ccl_combined", "carve_frames")):
        return {k.source.stem: k.launches for k in kernels
                if k.source.stem in names}

    def reset_counts():
        for k in kernels:
            k.launches = 0

    # -- [18a] the device builds against the f64 host tables --------------
    builds = {}
    for what, m in (("synthetic rig", model), ("rig", rig.model)):
        cams, grid, ref = m.cameras, m.grid, m._btab
        kw = dict(sub=ref.sub_shape, sup=ref.sup_shape,
                  color_camera=ref.color_camera, device=dev)
        dev_tab, dev_s = timed_s(lambda: cb.build_block_tables(
            cams, grid, image_hw, accelerate=True, **kw), torch, dev)
        _, host_s = timed_s(lambda: cb.build_block_tables(
            cams, grid, image_hw, accelerate=False, **kw), torch, dev)
        pt_dev, pt_dev_s = timed_s(lambda: carve.build_projection_tables(
            cams, grid, image_hw, accelerate=True, device=dev), torch, dev)
        pt_host, pt_host_s = timed_s(lambda: carve.build_projection_tables(
            cams, grid, image_hw, accelerate=False, device=dev), torch, dev)
        sus = suspicious_counts(torch, carve, cams, grid, image_hw, dev)
        expect(tables_equal(torch, dev_tab, ref)
               and torch.equal(pt_dev.valid, pt_host.valid)
               and torch.equal(pt_dev.lin_idx, pt_host.lin_idx),
               f"{what} at {grid.shape}: build_block_tables(accelerate=True) "
               f"on {dev.type} equal to the f64 host tables of phase "
               f"{3 if m is model else 14} (every field, WH {ref.WH}, WC "
               f"{ref.WC}, Hp {ref.Hp}, Wc {ref.Wc}), "
               "build_projection_tables(accelerate=True) to accelerate=False;"
               f" blocked {dev_s:.3f} s against the host's {host_s:.3f} s, "
               f"projection {pt_dev_s:.3f} s against {pt_host_s:.3f} s; "
               f"suspicious voxels per camera {sus} of {grid.num_voxels}")
        builds[what] = {"grid": list(grid.shape), "device_s": dev_s,
                        "host_s": host_s, "projection_device_s": pt_dev_s,
                        "projection_host_s": pt_host_s, "suspicious": sus}
        del dev_tab, pt_dev, pt_host
    report["builds"] = builds

    # -- [18b] the rig's steps at edge³ -----------------------------------
    print(f"  [18b] the rig at {edge}^3: build, live, offline, surface",
          flush=True)
    grid = GridConfig(nx=edge, ny=edge, nz=edge)
    cams, frames = rig.model.cameras, rig.frames

    def rig_model(src, d):
        m = VisualHull(cams, grid, src.rig, src.mask_params, device=d)
        m.bg_states, m.mog_params = src.bg_states, src.mog_params
        m._ensure_fast_state()
        return m

    m = rig_model(rig.model, dev)
    reset_peak(torch, dev)
    btab, build_s = timed_s(m._ensure_btab, torch, dev)
    build_peak = peak_gb(torch, dev)
    side = "device" if grid.num_voxels >= cb.DEVICE_BUILD_VOXELS else "host"
    kw = dict(sub=btab.sub_shape, sup=btab.sup_shape,
              color_camera=btab.color_camera)
    tab_cpu, cpu_s = timed_s(lambda: cb.build_block_tables_device(
        cams, grid, image_hw, device="cpu", **kw), torch, dev)
    gx, gy, gz = btab.nblocks
    slabs_equal = []
    for slab in (0, gx // 2):
        rows = slice(slab * gy * gz, (slab + 1) * gy * gz)
        got = btab.pk[rows].permute(2, 0, 1, 3).reshape(len(cams), -1)
        want = f64_words(cb, carve, cams, grid, image_hw,
                         btab.perm[rows].reshape(-1))
        slabs_equal.append(np.array_equal(got.cpu().numpy(), want.T))
    sus = suspicious_counts(torch, carve, cams, grid, image_hw, dev)
    share = sum(sus) / (len(cams) * grid.num_voxels)
    expect(tables_equal(torch, btab, tab_cpu) and all(slabs_equal),
           f"the rig at {grid.shape}: the model's {side} build ({build_s:.2f}"
           f" s, peak {build_peak} GB) equal to build_block_tables_device on "
           f"the CPU ({cpu_s:.2f} s); superblock x-slabs 0 and {gx // 2} "
           f"({len(cams)} x {btab.perm[:gy * gz].size} words each) equal to "
           f"the f64 projection; suspicious share {share:.5f} ({sus})")
    m_cpu = rig_model(rig.model_cpu, "cpu")
    m_cpu._btab = tables_on_cpu(btab)
    pt, pt_s = timed_s(lambda: m.tables, torch, dev)
    m_cpu._tables = carve.ProjectionTables(pt.valid.cpu(), pt.lin_idx.cpu(),
                                           pt.image_hw)
    vt = m.rig.views_threshold

    # the live step over the rig's frames
    m.process_frame_fast(frames[0])  # warm-up
    sync(torch, dev)
    reset_counts()
    outs, ms = [], []
    for fr in frames:
        out, s = timed_s(lambda: m.process_frame_fast(fr), torch, dev)
        outs.append(out)
        ms.append(s * 1e3)
    live_launches = launches(("carve_blocked", "ccl_combined"))
    live_ms = float(np.median(ms))
    t0 = time.perf_counter()
    same = [all(torch.equal(a.cpu(), b) for a, b in zip(
        out, m_cpu.process_frame_fast(fr))) for out, fr in zip(outs, frames)]
    cpu_live_s = time.perf_counter() - t0
    occ_t, col_t = m.process_frame(frames[0])
    occ0, col0 = outs[0]
    n_occ = [int(o.sum()) for o, _ in outs]
    expect(all(same) and torch.equal(occ_t, occ0)
           and torch.equal(col_t[occ_t], col0[occ_t]) and min(n_occ) > 0
           and (dev.type == "cpu" or min(live_launches.values())
                >= len(frames)),
           f"process_frame_fast at {grid.shape} over {len(frames)} rig "
           f"frames: occupancy and colours equal on {dev.type} and on the "
           f"CPU ({cpu_live_s:.1f} s), frame 0 equal to carve_from_tables on "
           f"the accelerated projection tables (built in {pt_s:.2f} s); "
           f"occupied voxels {n_occ}; launches {live_launches}")
    masks0 = m.masks(frames[0])
    active, full = cb.block_activity(masks0, vt, btab.allv, btab.ry, btab.rx)
    k1_args = (btab.pk, btab.lcc, active, full, masks0,
               m._frames(frames[0])[btab.color_camera].contiguous())
    k1_kw = dict(color_camera=btab.color_camera, views_threshold=vt)
    got = cb.carve_blocked_kernel(*k1_args, **k1_kw)
    want = cb.carve_blocked_plain(*k1_args, **k1_kw)
    k1_ms = timed_ms(lambda: cb.carve_blocked_kernel(*k1_args, **k1_kw),
                     torch, dev, flush=flush)
    k1 = k1_work(torch, cb, btab, active, full, masks0, got[0])
    nblk = btab.nsuper * btab.nsub
    k1_plan = cb.k1_launch_plan(nblk, len(cams)) if dev.type == "cuda" \
        else None
    expect(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"K1 at {grid.shape} bit-equal to its plain version; "
           f"process_frame_fast {live_ms:.3f} ms/frame (median of "
           f"{len(frames)}); K1 {k1_ms:.4f} ms, {k1.text}; launch {k1_plan}")

    # the offline path over OFFLINE_NF frames
    seq = np.stack(frames[:OFFLINE_NF])
    m.process_frames_offline(seq, frames_per_launch=OFFLINE_NF)  # warm-up
    sync(torch, dev)
    reset_counts()
    (occ_off, col_off), off_s = timed_s(lambda: m.process_frames_offline(
        seq, frames_per_launch=OFFLINE_NF), torch, dev)
    off_launches = launches()
    occ_off_c, col_off_c = m_cpu.process_frames_offline(
        seq, frames_per_launch=OFFLINE_NF)
    masks8 = torch.stack([m.masks(f) for f in seq])
    active8, full8 = cb.chunk_activity(masks8, btab, vt)
    got4 = cb.carve_frames_kernel(btab.pk, active8, full8, masks8,
                                  views_threshold=vt)
    want4 = cb.carve_frames_plain(btab.pk, active8, full8, masks8,
                                  views_threshold=vt)
    k4_ms = timed_ms(lambda: cb.carve_frames_kernel(
        btab.pk, active8, full8, masks8, views_threshold=vt), torch, dev,
        flush=flush)
    k4 = k4_work(torch, cb, btab, active8, full8, masks8, got4)
    offline_ms = off_s * 1e3 / len(seq)
    expect(np.array_equal(occ_off, occ_off_c)
           and all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(col_off, col_off_c))
           and torch.equal(got4, want4)
           and (dev.type == "cpu" or off_launches["carve_frames"] >= 1),
           f"process_frames_offline at {grid.shape} over {len(seq)} frames: "
           f"occupancy and colours equal on {dev.type} and on the CPU; K4 "
           f"bit-equal to its plain version; {offline_ms:.3f} ms/frame; K4 "
           f"{k4_ms:.4f} ms per chunk, {k4.text}; launches {off_launches}")
    del masks8, active8, full8, got4, want4

    # the surface step on two rig frames
    surface = {}
    for k in SURFACE_RIG_FRAMES:
        fr = frames[k]
        tris, occ, col = m.process_frame_surface(
            fr, *SURFACE_PAIR, capacity=SURFACE_CAPACITY)
        tris_c, occ_c, col_c = m_cpu.process_frame_surface(
            fr, *SURFACE_PAIR, capacity=SURFACE_CAPACITY)
        n_rep = int(mc.surface_program(
            occ.reshape(grid.shape), algorithm=SURFACE_PAIR[0],
            ambiguity=SURFACE_PAIR[1], capacity=SURFACE_CAPACITY)[2])
        path = "extract_mesh" if n_rep > SURFACE_CAPACITY else "device"

        def surface_step(fr=fr):
            m.process_frame_surface(fr, *SURFACE_PAIR,
                                    capacity=SURFACE_CAPACITY)
            sync(torch, dev)

        surf_ms = timed_ms(surface_step, torch, dev, reps=3)
        expect(np.array_equal(tris, tris_c) and len(tris) > 0
               and torch.equal(occ.cpu(), occ_c)
               and torch.equal(col.cpu(), col_c),
               f"process_frame_surface{SURFACE_PAIR} at {grid.shape} on rig "
               f"frame {k}: triangles, occupancy and colours equal on "
               f"{dev.type} and on the CPU; {len(tris)} triangles, "
               f"{n_rep} active cells reported (capacity "
               f"{SURFACE_CAPACITY}): path {path}; {surf_ms:.3f} ms/frame "
               "(median of 3)")
        surface[f"rig {k}"] = {"path": path, "n_reported": n_rep,
                               "triangles": len(tris), "ms": surf_ms}
    report["rig"] = {
        "grid": list(grid.shape), "build": side, "build_s": build_s,
        "build_peak_gb": build_peak, "cpu_build_s": cpu_s,
        "suspicious_share": share, "projection_tables_s": pt_s,
        "process_frame_fast_ms": live_ms, "live_launches": live_launches,
        "k1_ms": k1_ms, "k1_bound_ms": k1.bound, "k1_bound_by": k1.bound_by,
        "k1_active": k1.active, "k1_launch": k1_plan,
        "offline_ms_per_frame": offline_ms, "offline_launches": off_launches,
        "k4_ms": k4_ms, "k4_bound_ms": k4.bound, "k4_bound_by": k4.bound_by,
        "surface": surface}
    del m, m_cpu, btab, tab_cpu, pt, outs, occ_t, col_t, got, want, k1_args
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- [18c] the 8-camera carve at stretch³ -----------------------------
    print(f"  [18c] {STRETCH_CAMERAS} cameras at {stretch}^3: build, "
          "blocked, table and fused carves", flush=True)
    cams8, masks_np, frames_np = synthetic_rig(num_cameras=STRETCH_CAMERAS,
                                               image_hw=image_hw)
    grid = GridConfig(nx=stretch, ny=stretch, nz=stretch)
    # a voxel is kept where every camera sees it (as vbr_tpu's stretch
    # bench carves this rig, and as the 4-camera rig keeps at 4 of 4)
    rig8 = RigConfig(num_cameras=STRETCH_CAMERAS, image_height=H,
                     image_width=W, views_threshold=STRETCH_CAMERAS)
    picked = []
    real_build = cb.build_block_tables_device
    cb.build_block_tables_device = (
        lambda *a, **k: picked.append("device") or real_build(*a, **k))
    try:
        reset_peak(torch, dev)
        btab, build_s = timed_s(lambda: cb.build_block_tables(
            cams8, grid, image_hw, accelerate=None, device=dev), torch, dev)
        build_peak = peak_gb(torch, dev)
    finally:
        cb.build_block_tables_device = real_build
    side = "device" if grid.num_voxels >= cb.DEVICE_BUILD_VOXELS else "host"
    rng = np.random.default_rng(SEED + 18)
    M = min(STRETCH_SPOT, grid.num_voxels)
    at = [rng.integers(0, n, M) for n in (btab.nsuper, btab.nsub, cb.BV)]
    got = btab.pk[tuple(torch.from_numpy(a).to(dev) for a in at[:2])
                  + (slice(None), torch.from_numpy(at[2]).to(dev))]
    t0 = time.perf_counter()
    want = f64_words(cb, carve, cams8, grid, image_hw,
                     btab.perm[at[0], at[1], at[2]])
    spot_s = time.perf_counter() - t0
    expect((picked == ["device"]) == (side == "device")
           and np.array_equal(got.cpu().numpy(), want),
           f"build_block_tables(accelerate=None) at {grid.shape} x "
           f"{STRETCH_CAMERAS} cameras took the {side} build ({build_s:.2f} "
           f"s, peak {build_peak} GB); {M} random voxels per camera "
           f"re-projected in f64 on the host ({spot_s:.1f} s): pk words "
           "equal")
    reset_peak(torch, dev)
    pt, pt_s = timed_s(lambda: carve.build_projection_tables(
        cams8, grid, image_hw, device=dev), torch, dev)
    pt_peak = peak_gb(torch, dev)
    masks_d = torch.from_numpy(masks_np).to(dev)
    frames_d = torch.from_numpy(frames_np).to(dev)
    image = frames_d[btab.color_camera].contiguous()
    vt = rig8.views_threshold
    reset_counts()
    occ_b, col_b = cb.carve_blocked(masks_d, image, btab, views_threshold=vt)
    sync(torch, dev)
    carve_launches = launches(("carve_blocked",))
    occ_t, col_t = carve.carve_from_tables(
        masks_d, frames_d, pt.valid, pt.lin_idx, views_threshold=vt,
        color_camera=rig8.color_camera)
    nblk = btab.nsuper * btab.nsub
    k1_plan = cb.k1_launch_plan(nblk, STRETCH_CAMERAS) \
        if dev.type == "cuda" else None
    expect(torch.equal(occ_b, occ_t) and torch.equal(col_b[occ_t],
                                                     col_t[occ_t])
           and 0 < int(occ_t.sum()) < grid.num_voxels
           and (dev.type == "cpu" or carve_launches["carve_blocked"] == 1
                and k1_plan["route"] == "direct"),
           f"carve_blocked at {grid.shape} x {STRETCH_CAMERAS} cameras: "
           "occupancy and colours of occupied voxels equal to "
           "carve_from_tables on the accelerated projection tables "
           f"({pt_s:.2f} s, peak {pt_peak} GB); {int(occ_t.sum())} occupied; "
           f"launches {carve_launches}; K1 launch {k1_plan}")
    del occ_b, col_b
    reset_peak(torch, dev)
    fused = Reconstructor(cams8, grid, rig8, use_tables=False, device=dev)
    occ_f, col_f = fused.carve_frame(masks_d, frames_d)
    sync(torch, dev)
    fused_peak = peak_gb(torch, dev)
    differ = int((occ_f != occ_t).sum())
    expect(differ <= 1e-4 * grid.num_voxels,
           f"Reconstructor(use_tables=False) at {grid.shape}: {differ} of "
           f"{grid.num_voxels} voxels differ from the table path (peak "
           f"{fused_peak} GB)")
    del occ_f, col_f, occ_t, col_t
    active, full = cb.block_activity(masks_d, vt, btab.allv, btab.ry, btab.rx)
    k1_args = (btab.pk, btab.lcc, active, full, masks_d, image)
    k1_kw = dict(color_camera=btab.color_camera, views_threshold=vt)
    occ_k, _ = cb.carve_blocked_kernel(*k1_args, **k1_kw)
    k1_ms = timed_ms(lambda: cb.carve_blocked_kernel(*k1_args, **k1_kw),
                     torch, dev, reps=5, flush=flush)
    k1 = k1_work(torch, cb, btab, active, full, masks_d, occ_k)
    del occ_k
    blocked_ms = timed_ms(lambda: cb.carve_blocked(
        masks_d, image, btab, views_threshold=vt, layout="blocked"), torch,
        dev, reps=5, flush=flush)
    table_ms = timed_ms(lambda: carve.carve_from_tables(
        masks_d, frames_d, pt.valid, pt.lin_idx, views_threshold=vt,
        color_camera=rig8.color_camera), torch, dev, reps=5, flush=flush)
    fused_ms = timed_ms(lambda: fused.carve_frame(masks_d, frames_d), torch,
                        dev, reps=5, flush=flush)
    print(f"  at {grid.shape} x {STRETCH_CAMERAS}: K1 {k1_ms:.4f} ms, "
          f"{k1.text}; ms per frame: block_activity + K1 {blocked_ms:.3f}, "
          f"table carve {table_ms:.3f}, fused carve {fused_ms:.3f}")
    report["stretch"] = {
        "grid": list(grid.shape), "cameras": STRETCH_CAMERAS, "build": side,
        "build_s": build_s, "build_peak_gb": build_peak, "spot_voxels": M,
        "spot_s": spot_s, "projection_tables_s": pt_s,
        "projection_peak_gb": pt_peak, "fused_peak_gb": fused_peak,
        "fused_differ": differ, "launches": carve_launches, "k1_ms": k1_ms,
        "k1_bound_ms": k1.bound, "k1_bound_by": k1.bound_by,
        "k1_active": k1.active, "k1_launch": k1_plan,
        "blocked_ms": blocked_ms, "table_ms": table_ms, "fused_ms": fused_ms}
    if keep is not None:
        keep.update(btab=btab, masks=masks_d, image=image, views_threshold=vt)
    del btab, pt, fused, masks_d, frames_d, image, k1_args, active, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- [18d] Reconstructor(use_tables=False) on the rig ------------------
    grid = rig.model.grid
    masks = np.where(rig_silhouettes(image_hw), 255, 0).astype(np.uint8)
    fr = frames[0]
    fused = {d: Reconstructor(cams, grid, rig.model.rig, use_tables=False,
                              device=d) for d in (dev, "cpu")}
    occ_f, col_f = fused[dev].carve_frame(masks, fr)
    occ_c, col_c = fused["cpu"].carve_frame(masks, fr)
    occ_t, _ = Reconstructor(cams, grid, rig.model.rig,
                             device=dev).carve_frame(masks, fr)
    masks_d = torch.from_numpy(masks).to(dev)
    fr_d = torch.from_numpy(fr).to(dev)
    fused_ms = timed_ms(lambda: fused[dev].carve_frame(masks_d, fr_d), torch,
                        dev, flush=flush)
    differ = int((occ_f != occ_t).sum())
    expect(torch.equal(occ_f.cpu(), occ_c) and torch.equal(col_f.cpu(), col_c)
           and differ <= 1e-4 * grid.num_voxels and int(occ_c.sum()) > 0,
           f"Reconstructor(use_tables=False) at {grid.shape} on the rig: "
           f"occupancy and colours equal on {dev.type} and on the CPU; "
           f"{differ} voxels differ from use_tables=True; "
           f"{fused_ms:.3f} ms/frame")
    report["rig_fused"] = {"grid": list(grid.shape), "differ": differ,
                           "ms": fused_ms}
    return report


CALIB_NPZ = "artifacts/intrinsics_run/cam{}/photometric_calib.npz"
CALIB_HW = (486, 644)  # the intrinsics capture's frames
CALIB_PATTERN = (8, 6)  # the real board's inner corners
CALIB_SQUARE = 115.0  # its squares, mm
CALIB_ITERS = 3000  # ``calibrate_video_photometric``'s default
CALIB_NOISE_PX = 0.3
RENDER_SS = 3  # supersampling per axis
DISCARD_VIEWS = 12
ADAM_STEPS = 50  # steps held card vs CPU and graph vs eager


def calib_truth(cam, image_hw, views=None):
    """(K, dist, rvecs, tvecs) of camera ``cam``'s fit in ``CALIB_NPZ``:
    all its poses, or ``views`` of them spread evenly over the capture; K
    scaled from ``CALIB_HW`` to ``image_hw`` (even sizes: ``vbr_tpu``'s
    blob finder fails on a blob in the last row of an odd height)."""
    with np.load(CALIB_NPZ.format(cam)) as d:
        K, dist, rvecs, tvecs = (np.asarray(d[k], np.float64)
                                 for k in ("K", "dist", "rvecs", "tvecs"))
    K = K * np.array([[image_hw[1] / CALIB_HW[1]],
                      [image_hw[0] / CALIB_HW[0]], [1.0]])
    if views is not None and views < len(rvecs):  # spread over the capture
        keep = np.linspace(0, len(rvecs) - 1, views).round().astype(int)
        rvecs, tvecs = rvecs[keep], tvecs[keep]
    return K, dist, rvecs, tvecs


def render_boards(torch, dev, K, dist, rvecs, tvecs, image_hw,
                  ss=RENDER_SS, background=None):
    """(V, H, W, 3) u8 BGR frames of the board at each pose, rendered on
    ``dev`` as ``tests/test_photometric_calibration.py::render_board``
    renders one: per sub-pixel sample the f64 ray through the undistorted
    pixel (25 fixed-point rounds) meets the board plane; black squares 25,
    the board and its 0.7-square margin 235, beyond 90 (or the pixel of
    the (H, W, 3) u8 ``background``); the mean of ``ss``² samples,
    truncated to u8."""
    from vbr_tpu_torch.ops import camera as cam_ops

    H, W = image_hw
    nu, nv = CALIB_PATTERN[0] + 1, CALIB_PATTERN[1] + 1
    f64 = dict(dtype=torch.float64, device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    offs = (torch.arange(ss, **f64) + 0.5) / ss - 0.5
    pix = torch.stack([
        torch.stack([(xs + ox).reshape(-1), (ys + oy).reshape(-1)], -1)
        for oy in offs for ox in offs])  # (ss², H·W, 2)
    nrm = cam_ops.undistort_points(pix, torch.as_tensor(K, **f64),
                                   torch.as_tensor(dist, **f64), num_iters=25)
    d = torch.cat([nrm, torch.ones_like(nrm[..., :1])], -1)
    if background is not None:
        bgf = torch.as_tensor(background, **f64).reshape(-1, 3)
    out = []
    for rv, tv in zip(rvecs, tvecs):
        R = cam_ops.rodrigues(rv)
        Rt_t = torch.as_tensor(R.T @ tv, **f64)
        rd = d @ torch.as_tensor(R, **f64)  # rows: Rᵀd
        lam = Rt_t[2] / rd[..., 2]
        Xb = lam[..., None] * rd - Rt_t
        u = Xb[..., 0] / CALIB_SQUARE + 1.0
        v = Xb[..., 1] / CALIB_SQUARE + 1.0
        inside = (u >= 0) & (u < nu) & (v >= 0) & (v < nv)
        margin = (u >= -0.7) & (u < nu + 0.7) & (v >= -0.7) & (v < nv + 0.7)
        black = (torch.floor(u).long() + torch.floor(v).long()) % 2 == 0
        val = torch.where(inside & black, 25.0,
                          torch.where(margin, 235.0, 90.0)).to(torch.float64)
        if background is None:
            g = (val.sum(0) / ss / ss).reshape(H, W).to(torch.uint8)
            out.append(g[..., None].expand(H, W, 3))
        else:  # the samples off the sheet take the background's pixel
            on = torch.where(margin, val, 0.0).sum(0)
            off = (~margin).sum(0).to(torch.float64)
            g = (on[:, None] + off[:, None] * bgf) / ss / ss
            out.append(g.reshape(H, W, 3).to(torch.uint8))
    return torch.stack(out).cpu().numpy()


def true_corners(K, dist, rvecs, tvecs):
    """(V, N, 2) f64 projections of the board's inner corners."""
    from vbr_tpu_torch.ops import camera as cam_ops
    from vbr_tpu_torch.pipelines import calibration as calib

    obj = calib.chessboard_object_points(CALIB_PATTERN, CALIB_SQUARE)
    return np.stack([cam_ops.project_points(obj, rv, tv, K, dist)
                     for rv, tv in zip(rvecs, tvecs)])


def board_radius(K, dist, rvecs, tvecs, image_hw):
    """The largest normalized radius of a board corner inside the image:
    the range over which the radial curve is determined."""
    from vbr_tpu_torch.ops import camera as cam_ops
    from vbr_tpu_torch.pipelines import calibration as calib

    obj = calib.chessboard_object_points(CALIB_PATTERN, CALIB_SQUARE)
    H, W = image_hw
    rmax = 0.0
    for rv, tv in zip(rvecs, tvecs):
        Xc = obj @ cam_ops.rodrigues(rv).T + tv
        r = np.hypot(Xc[:, 0] / Xc[:, 2], Xc[:, 1] / Xc[:, 2])
        uv = cam_ops.project_points(obj, rv, tv, K, dist)
        ok = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
              & (uv[:, 1] < H))
        if ok.any():
            rmax = max(rmax, float(r[ok].max()))
    return rmax


def radial_curve_err_px(dist, dist_true, rmax, f):
    """Largest pixel error of the radial distortion curve over r ≤ rmax
    (``tests/test_photometric_calibration.py``'s measure)."""
    r = np.linspace(0.0, rmax, 200)
    r2 = r * r

    def rad(d):
        return d[0] * r2 + d[1] * r2 ** 2 + d[4] * r2 ** 3

    return float(np.abs((rad(dist) - rad(dist_true)) * r * f).max())


def rel_err(a, b):
    """Largest |a − b| / |b| over the arrays' elements."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())


def calib_rel_err(a, b):
    """Largest relative difference of two ``CalibrationResult``s over K,
    dist, poses, rms and per-view errors."""
    return max(rel_err(a.K, b.K), rel_err(a.dist, b.dist),
               rel_err(np.stack(a.rvecs), np.stack(b.rvecs)),
               rel_err(np.stack(a.tvecs), np.stack(b.tvecs)),
               rel_err(a.rms, b.rms),
               rel_err(a.per_view_errors, b.per_view_errors))


def calibration_phase(torch, dev, image_hw=CALIB_HW, views=None,
                      iters=CALIB_ITERS, build_root="build", keep=None):
    """Phase 19: intrinsic calibration (see ``run``) on boards rendered at
    the real cameras and poses of ``CALIB_NPZ``, at ``image_hw`` (K
    scaled), the first ``views`` poses per camera, ``iters`` Adam steps.
    Keeps cam1's boards and its discard views in ``keep`` (for phase 24).
    Returns its report."""
    from vbr_tpu_torch.ops import color, corners
    from vbr_tpu_torch.pipelines import calibration as calib
    from vbr_tpu_torch.pipelines import photometric_calibration as pc
    from vbr_tpu_torch.utils import xmlio

    cpu = torch.device("cpu")
    H, W = image_hw
    t_phase = time.perf_counter()
    reset_peak(torch, dev)
    rep = {"image_hw": list(image_hw), "iters": iters, "cameras": {}}
    rigs = {}
    for cam in (1, 2, 3, 4):
        K, dist, rvecs, tvecs = calib_truth(cam, image_hw, views)
        frames, render_s = timed_s(lambda: render_boards(
            torch, dev, K, dist, rvecs, tvecs, image_hw), torch, dev)
        rigs[cam] = (K, dist, rvecs, tvecs, frames)
        rep["cameras"][cam] = {"views": len(rvecs), "render_s": render_s}
    split = {"render": time.perf_counter() - t_phase}
    t_part = time.perf_counter()

    def part(name):  # seconds since the last part ended, into ``split``
        nonlocal t_part
        now = time.perf_counter()
        split[name] = split.get(name, 0.0) + now - t_part
        t_part = now

    n_views = sum(len(r[2]) for r in rigs.values())
    print(f"  {n_views} views rendered at {W}x{H} on {dev.type} in "
          f"{sum(c['render_s'] for c in rep['cameras'].values()):.2f} s")

    # first calls, timed apart: the device's first f64 solve loads its
    # solver library; the process's first forward-mode derivative of a
    # tensor-scalar operation on the card takes seconds (any later one,
    # milliseconds), so the first LM is not charged with it
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    _, rep["first_solve_s"] = timed_s(
        lambda: torch.linalg.solve(eye, eye[0]), torch, dev)
    _, rep["first_jacfwd_s"] = timed_s(
        lambda: torch.func.jacfwd(lambda v: v + 1.0)(eye[0]), torch, dev)
    print(f"  first calls on {dev.type}: f64 solve {rep['first_solve_s']:.2f}"
          f" s, torch.func.jacfwd {rep['first_jacfwd_s']:.2f} s")
    part("first calls")

    # -- the corners method: cmd_calibrate's sequence ---------------------
    noisy = {}
    for cam, (K, dist, rvecs, tvecs, frames) in rigs.items():
        c = rep["cameras"][cam]
        gray = color.bgr_to_gray_u8(torch.from_numpy(frames).to(dev))
        gray_h = gray.cpu().numpy()
        t0 = time.perf_counter()
        det = [corners.detect_chessboard(gray[i], CALIB_PATTERN)
               for i in range(len(frames))]
        c["detect_ms_per_view"] = (time.perf_counter() - t0) * 1e3 / len(det)
        t0 = time.perf_counter()
        det_cpu = [corners.detect_chessboard(gray_h[i], CALIB_PATTERN,
                                             device="cpu")
                   for i in range(len(frames))]
        c["detect_cpu_ms_per_view"] = ((time.perf_counter() - t0) * 1e3
                                       / len(det))
        part("detect")
        found = [i for i, p in enumerate(det) if p is not None]
        expect(found == [i for i, p in enumerate(det_cpu) if p is not None],
               f"cam{cam}: detect_chessboard finds the board in the same "
               f"{len(found)} of {len(det)} views on {dev.type} and on the CPU")
        diff = max((float(np.abs(det[i] - det_cpu[i]).max()) for i in found),
                   default=0.0)
        expect(diff <= 1e-3, f"cam{cam}: corners on {dev.type} and the CPU "
               f"within {diff:.2e} px (<= 1e-3)")
        truth = true_corners(K, dist, rvecs, tvecs)
        if found:  # corner_subpix alone from the true corners, 1 px off
            i = found[0]
            init = truth[i] + np.random.default_rng(cam).uniform(
                -1, 1, truth[i].shape)
            q, n_it = corners.corner_subpix(gray[i], init, return_iters=True)
            q_c, n_it_c = corners.corner_subpix(gray_h[i], init,
                                                return_iters=True,
                                                device="cpu")
            c["subpix"] = {
                "max_diff_px": float(np.abs(q.cpu().numpy()
                                            - q_c.numpy()).max()),
                "iters_equal": bool(torch.equal(n_it.cpu(), n_it_c)),
                "mean_iters": float(n_it_c.float().mean())}
            expect(c["subpix"]["max_diff_px"] <= 1e-3,
                   f"cam{cam}: corner_subpix on {dev.type} and the CPU within "
                   f"{c['subpix']['max_diff_px']:.1e} px; iteration counts "
                   f"{'equal' if c['subpix']['iters_equal'] else 'differ'}")
        errs = np.concatenate([np.linalg.norm(
            det[i][:, None] - truth[i][None], axis=-1).min(1) for i in found]
        ) if found else np.zeros(0)
        c["detected"] = len(found)
        c["corner_err_px"] = ({"median": float(np.median(errs)),
                               "max": float(errs.max())} if found else None)
        print(f"  cam{cam}: {len(found)}/{len(det)} views detected, "
              f"{c['detect_ms_per_view']:.1f} ms/view ({dev.type}), "
              f"{c['detect_cpu_ms_per_view']:.1f} ms/view (CPU); corner "
              f"error vs truth {c['corner_err_px']}")
        rng = np.random.default_rng(SEED + cam)
        noisy[cam] = [t + rng.normal(0, CALIB_NOISE_PX, t.shape)
                      for t in truth]
        sets = [("noisy", noisy[cam])]
        if len(found) >= 3:
            sets.insert(0, ("detected", [det[i].astype(np.float32)
                                         for i in found]))
        c["lm"] = {}
        for name, pts in sets:
            res, lm_s = timed_s(lambda: calib.calibrate_camera(
                pts, (W, H), CALIB_PATTERN, CALIB_SQUARE, device=dev),
                torch, dev)
            res_cpu, lm_cpu_s = timed_s(lambda: calib.calibrate_camera(
                pts, (W, H), CALIB_PATTERN, CALIB_SQUARE, device="cpu"),
                torch, cpu)
            err = calib_rel_err(res, res_cpu)
            expect(err <= 1e-6, f"cam{cam}: calibrate_camera on the "
                   f"{len(pts)} {name} views, {dev.type} vs CPU: K, dist, "
                   f"poses, rms, per-view errors within rtol {err:.1e}")
            c["lm"][name] = {"views": len(pts), "seconds": lm_s,
                             "cpu_seconds": lm_cpu_s, "rms": res.rms,
                             "fx": res.K[0, 0], "fy": res.K[1, 1],
                             "fx_err": res.K[0, 0] / K[0, 0] - 1,
                             "rtol": err}
            if name == "noisy" and cam == 1:
                lm1 = res
            print(f"  cam{cam} {name}: LM {lm_s:.2f} s ({dev.type}), "
                  f"{lm_cpu_s:.2f} s (CPU); rms {res.rms:.3f} px, fx "
                  f"{res.K[0, 0]:.2f} vs {K[0, 0]:.2f}")
            part("lm")

    # leave-one-out discarding on cam1's first views, both devices
    pts = list(noisy[1][:DISCARD_VIEWS])
    if len(pts) > 2:  # one view corrupted, as tests/test_calibration.py does
        pts[2] = pts[2] + np.random.default_rng(SEED).normal(0, 3.0,
                                                             pts[2].shape)
    out = calib.discard_bad_image_points(pts, (W, H), CALIB_PATTERN,
                                         CALIB_SQUARE, device=dev)
    out_cpu = calib.discard_bad_image_points(pts, (W, H), CALIB_PATTERN,
                                             CALIB_SQUARE, device="cpu")
    expect(out[1] == out_cpu[1] and out[3] == out_cpu[3],
           f"discard_bad_image_points on cam1's first {len(pts)} views: "
           f"the same views kept and dropped on {dev.type} and on the CPU "
           f"(dropped {out[3]})")
    rep["discarded"] = out[3]
    if keep is not None:
        keep["board"] = rigs[1]
        keep["discard"] = (pts, out[0], (W, H))
    part("discard")
    cam_dir = os.path.join(build_root, "calib_config", "cam1")
    xmlio.save_camera_config(cam_dir, lm1.K, lm1.dist, lm1.rvecs[0],
                             lm1.tvecs[0])
    back = xmlio.load_camera_config(cam_dir)
    expect(all(np.array_equal(np.asarray(a, np.float64).ravel(),
                              np.asarray(b, np.float64).ravel())
               for a, b in zip(back, (lm1.K, lm1.dist, lm1.rvecs[0],
                                      lm1.tvecs[0]))),
           "save_camera_config then load_camera_config gives cam1's K, "
           "dist, rvec and tvec back bit for bit")

    # -- the photometric method -------------------------------------------
    for cam, (K, dist, rvecs, tvecs, frames) in rigs.items():
        c = rep["cameras"][cam]
        (res, pviews), photo_s = timed_s(
            lambda: pc.calibrate_video_photometric(
                iter(list(frames)), CALIB_PATTERN, CALIB_SQUARE, iters=iters,
                device=dev), torch, dev)
        init = calib.calibrate_camera([v.corners for v in pviews], (W, H),
                                      CALIB_PATTERN, CALIB_SQUARE, device=dev)
        rmax = board_radius(K, dist, rvecs, tvecs, image_hw)
        curve = radial_curve_err_px(res.dist, dist, rmax, K[0, 0])
        curve0 = radial_curve_err_px(np.asarray(init.dist)[:5], dist, rmax,
                                     K[0, 0])
        fx_err = res.K[0, 0] / K[0, 0] - 1
        fy_err = res.K[1, 1] / K[1, 1] - 1
        c["photometric"] = {
            "views": len(pviews), "seconds": photo_s, "fx": res.K[0, 0],
            "fy": res.K[1, 1], "fx_err": fx_err, "fy_err": fy_err,
            "cx_err_px": res.K[0, 2] - K[0, 2],
            "cy_err_px": res.K[1, 2] - K[1, 2],
            "radial_curve_err_px": curve, "warm_start_curve_err_px": curve0,
            "warm_start_fx_err": init.K[0, 0] / K[0, 0] - 1,
            "rmax": rmax, "final_loss": float(res.loss_curve[-1]),
            "median_mse": float(np.median(res.mse))}
        print(f"  cam{cam} photometric: {len(pviews)} views, {photo_s:.2f} s;"
              f" fx {res.K[0, 0]:.2f} ({fx_err:+.4f}), fy {res.K[1, 1]:.2f} "
              f"({fy_err:+.4f}), cx {res.K[0, 2] - K[0, 2]:+.2f} px, cy "
              f"{res.K[1, 2] - K[1, 2]:+.2f} px; radial curve "
              f"{curve:.3f} px (warm start {curve0:.3f})")
        if iters == CALIB_ITERS:  # the bounds of the production schedule
            expect(abs(fx_err) < 0.01 and abs(fy_err) < 0.01,
                   f"cam{cam}: photometric fx and fy within 1 % of the truth")
            expect(curve < curve0, f"cam{cam}: the radial curve ends closer "
                   "to the truth than the warm start's")
        if cam == 1:
            views1, init1 = pviews, init
        part("photometric")

    # -- cam1: the card against the CPU, the graph against eager ----------
    init_t = (init1.K, np.asarray(init1.dist)[:5].copy(),
              list(zip(init1.rvecs, init1.tvecs)))
    probs = {d: pc.PhotometricProblem(views1, (W, H), CALIB_PATTERN,
                                      CALIB_SQUARE, init=init_t, device=d)
             for d in (dev, cpu)}
    L, g = probs[dev].value_and_grad()
    L_cpu, g_cpu = probs[cpu].value_and_grad()
    F = probs[dev].F
    groups = {"intrinsics": slice(0, 4), "dist": slice(4, 9),
              "poses": slice(9, 9 + 6 * F), "nuisance": slice(9 + 6 * F, None)}
    g_err = {k: float(np.abs(g[s] - g_cpu[s]).max() / np.abs(g_cpu[s]).max())
             for k, s in groups.items()}
    expect(rel_err(L, L_cpu) <= 1e-5 and max(g_err.values()) <= 1e-3,
           f"cam1 at the warm start: loss on {dev.type} and the CPU within "
           f"rtol {rel_err(L, L_cpu):.1e}, gradient within "
           f"{max(g_err.values()):.1e} of each group's largest")
    n_nuis = min(400, iters // 6)  # the production schedule's first stage
    n_first = min(ADAM_STEPS, iters)
    first = [(min(n_first, n_nuis), "nuisance"),
             (n_first - min(n_first, n_nuis), "all")]
    p_g, curve_g = probs[dev].run(first)
    p_c, curve_c = probs[cpu].run(first)
    expect(rel_err(curve_g, curve_c) <= 1e-3,
           f"cam1: the first {n_first} Adam steps' losses on {dev.type} "
           f"and the CPU within rtol {rel_err(curve_g, curve_c):.1e}")
    route = "graph" if dev.type == "cuda" else "eager"
    adam = {"route": route,
            f"{route}_ms_per_step": probs[dev].ms_per_step}
    if dev.type == "cuda":
        p_e, curve_e = probs[dev].run(first, route="eager")
        expect(torch.equal(p_e, p_g) and np.array_equal(curve_e, curve_g),
               f"cam1: {n_first} Adam steps replayed from the CUDA graph "
               "bit-equal to the eager steps (parameters and losses)")
        adam["eager_ms_per_step"] = probs[dev].ms_per_step
    print(f"  Adam ms per step at {F} views x {probs[dev].S} samples: "
          + ", ".join(f"{k} {v:.3f}" for k, v in adam.items()
                      if k != "route"))
    rep["adam"] = adam
    K1 = rigs[1][0]
    pin = np.round(K1[:2, 2] * 64) / 64  # the truth, held exactly in f32
    res_pp = pc.photometric_calibrate(  # calibrate_video_photometric's fit
        views1, (W, H), CALIB_PATTERN, CALIB_SQUARE, init=init_t,
        stages=[(n_nuis, "nuisance"), (iters - n_nuis, "all")],
        fix_pp=tuple(pin), device=dev)
    pp_err = float(np.abs(res_pp.K[:2, 2] - pin).max())
    expect(pp_err <= 1e-6, f"cam1 with fix_pp, {iters} steps: cx and cy "
           f"pinned within {pp_err:.1e} px; fx {res_pp.K[0, 0]:.2f}")
    rep["fix_pp"] = {"fx_err": res_pp.K[0, 0] / K1[0, 0] - 1,
                     "fy_err": res_pp.K[1, 1] / K1[1, 1] - 1}
    part("cam1 checks")
    rep["split_s"] = split
    print("  phase 19 by part (s): " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in split.items()))
    rep["peak_gb"] = peak_gb(torch, dev)
    rep["seconds"] = time.perf_counter() - t_phase
    return rep


EXT_BOARD_FRAMES = 16  # checkerboard frames per camera
EXT_BG_FRAMES = 120  # background frames per camera
EXT_NOISE = 2.0  # σ of the board frames' seeded noise
EXT_ITERS = 400  # photometric_refine's steps (``auto_extrinsics``' default)
EXT_GRID = 64  # the edge of carve_silhouette_ab's grid
# vbr_tpu's own bounds for a recovered pose (tests/test_auto_extrinsics.py)
EXT_BOUND_RAD = 0.01
EXT_BOUND_MM = 25.0
EXT_MOG2_ROWS = 96  # rows of cam1 that MOG2 is held on against the CPU
# photometric_refine card vs CPU: the reference's own spread under a
# one-ulp change of the start is ~1e-15 rad and ~1e-12 mm, far below these
EXT_REFINE_RAD = 1e-6
EXT_REFINE_MM = 1e-3


def rig_background(rng, image_hw):
    """A seeded textured BGR image: 16-pixel blocks of one colour in
    [80, 170] per channel plus ±6 per pixel, so the white sheet (235), the
    black squares (25) and the dark subject (< 24) all differ from it by
    more than the change thresholds (40, 35)."""
    H, W = image_hw
    blocks = rng.integers(80, 171, (-(-H // 16), -(-W // 16), 3))
    img = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:H, :W]
    img = img + rng.integers(-6, 7, (H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def extrinsics_scene(torch, dev, image_hw, n_cams=4, bg_frames=EXT_BG_FRAMES,
                     board_frames=EXT_BOARD_FRAMES):
    """Phase 20's scene: the first ``n_cams`` cameras of ``RIG_DIR`` (K
    scaled to ``image_hw``), each with a seeded textured background, its
    background frames (the image ±4), its checkerboard frames (the board
    rendered on ``dev`` at the committed pose over the background, seeded
    noise of σ = ``EXT_NOISE``) and one person frame (the rig's silhouettes
    painted over the background)."""
    from vbr_tpu_torch.utils.config import CameraParams

    rng = np.random.default_rng(SEED + 20)
    arrays = [tuple(np.asarray(a, np.float64).reshape(-1) if i else a
                    for i, a in enumerate(cam))
              for cam in rig_cameras(image_hw)[:n_cams]]
    bgs = np.stack([rig_background(rng, image_hw) for _ in arrays])
    boards, backs = [], []
    for (K, dist, rv, tv), bg in zip(arrays, bgs):
        clean = render_boards(torch, dev, K, dist, [rv], [tv], image_hw,
                              background=bg)[0]
        noise = rng.standard_normal((board_frames,) + clean.shape,
                                    dtype=np.float32) * EXT_NOISE
        boards.append(np.clip(np.rint(clean + noise), 0, 255).astype(np.uint8))
        jitter = rng.integers(-4, 5, (bg_frames,) + bg.shape, dtype=np.int8)
        backs.append(np.clip(bg + jitter.astype(np.int16), 0, 255)
                     .astype(np.uint8))
    sils = rig_silhouettes(image_hw)[:n_cams]
    return SimpleNamespace(
        cams=[CameraParams.from_arrays(*a) for a in arrays], bgs=bgs,
        boards=boards, backs=backs, sils=sils,
        person=paint_silhouettes(rng, bgs, sils))


def pose_errors(cams, truth):
    """Per camera (rad, mm) of ``cams``' poses against ``truth``'s, in the
    nearer of the two global board frames (camera 0 anchors the recovered
    rig, so it may sit in the 180°-rotated frame): (errors, flipped)."""
    from vbr_tpu_torch.pipelines.auto_extrinsics import flip_pose_180

    def errs(flip):
        out = []
        for c, t in zip(cams, truth):
            rv, tv = t.rvec, t.tvec
            if flip:
                rv, tv = flip_pose_180(rv, tv)
            out.append((float(np.linalg.norm(c.rvec - rv)),
                        float(np.linalg.norm(c.tvec - tv))))
        return out

    a, b = errs(False), errs(True)
    flipped = sum(r for r, _ in b) < sum(r for r, _ in a)
    return (b if flipped else a), flipped


def extrinsics_phase(torch, dev, bg_seqs, tr_states, tr_params, frames,
                     seeded_states, models_dir, rig_frame, mask_params,
                     image_hw=RIG_HW, n_cams=4, iters=EXT_ITERS,
                     bg_frames=EXT_BG_FRAMES, ab_grid=EXT_GRID, keep=None):
    """Phase 20 (see ``run``): extrinsic calibration on ``extrinsics_scene``
    at ``image_hw`` with ``n_cams`` cameras, ``iters`` photometric steps and
    ``bg_frames`` background frames, then MOG2, KNN, ``raw_masks_batched``
    and ``BackgroundPipeline`` on phase 10's sequences ``bg_seqs``, its
    trained states ``tr_states`` (``tr_params``) and the synthetic rig's
    ``frames``, and on phase 14's seeded models (``seeded_states``, written
    to ``models_dir``) with its ``rig_frame``.  Keeps the three models'
    masks of ``frames`` in ``keep`` (for phase 24).  Returns its report."""
    from vbr_tpu_torch.ops import corners, gmm
    from vbr_tpu_torch.pipelines import auto_extrinsics as ax
    from vbr_tpu_torch.pipelines import background
    from vbr_tpu_torch.pipelines import calibration as calib
    from vbr_tpu_torch.pipelines import extrinsics_eval as ev
    from vbr_tpu_torch.utils.config import GridConfig

    cpu = torch.device("cpu")
    sides = (("card", dev), ("cpu", cpu))  # "card" is ``dev``, whatever it is
    t_phase = time.perf_counter()
    reset_peak(torch, dev)
    split = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        split[name] = split.get(name, 0.0) + now - t_part
        t_part = now

    sc = extrinsics_scene(torch, dev, image_hw, n_cams, bg_frames)
    truth = sc.cams
    rep = {"image_hw": list(image_hw), "cameras": n_cams, "iters": iters}
    part("scene")

    # -- 1. auto_extrinsics on the card ----------------------------------
    res, rep["auto_extrinsics_s"] = timed_s(lambda: ax.auto_extrinsics(
        sc.boards, sc.backs, sc.person, truth, photometric_iters=iters,
        device=dev), torch, dev)
    errs, flipped = pose_errors(res.cameras, truth)
    rep.update(n_blobs=res.n_blobs, n_matched=res.n_matched,
               photometric_mse=res.photometric_mse, flips=res.flips,
               votes={"".join("F" if f else "-" for f in k): v
                      for k, v in res.votes.items()},
               pose_err_rad=[e[0] for e in errs],
               pose_err_mm=[e[1] for e in errs], global_flip=flipped)
    print(f"  auto_extrinsics on {dev.type}: {rep['auto_extrinsics_s']:.2f}"
          f" s; blobs {res.n_blobs}, matched {res.n_matched}, photometric "
          f"MSE {np.round(res.photometric_mse, 2).tolist()}, flips "
          f"{res.flips}, votes {sorted(res.votes.values(), reverse=True)}")
    print("  pose errors against the committed rig (global frame "
          f"{'flipped' if flipped else 'as committed'}): rad "
          f"{[f'{e[0]:.2e}' for e in errs]}, mm "
          f"{[f'{e[1]:.3f}' for e in errs]}")
    if iters == EXT_ITERS:  # the production schedule's bounds
        expect(all(r < EXT_BOUND_RAD and t < EXT_BOUND_MM for r, t in errs),
               f"every recovered pose within {EXT_BOUND_RAD} rad and "
               f"{EXT_BOUND_MM} mm of the committed rig")
    part("auto_extrinsics")

    # -- 2. cam1, stage by stage, the card against the CPU ---------------
    K, dist = truth[0].K, truth[0].dist
    gray = ax.temporal_mean_gray(sc.boards[0])
    bg = ax.median_background(sc.backs[0])
    sheets = []
    for d in (dev, cpu):
        region = ax.largest_change_region(bg, sc.boards[0][0], device=d)
        hull = corners._convex_hull(
            np.stack(np.nonzero(region)[::-1], -1).astype(np.float64))
        sheets.append(ax.convex_fill(hull, gray.shape))
    expect(np.array_equal(*sheets), f"cam1: the board sheet on {dev.type} "
           f"and on the CPU equal ({int(sheets[0].sum())} pixels)")
    t0 = time.perf_counter()
    cents, thr = ax.detect_black_squares(gray, sheets[0])
    rep["detect_black_squares_ms"] = (time.perf_counter() - t0) * 1e3
    cents_c, thr_c = ax.detect_black_squares(gray, sheets[1])
    expect(np.array_equal(cents, cents_c) and thr == thr_c,
           f"cam1: detect_black_squares on the two sheets: the same "
           f"{len(cents)} centroids and threshold {thr:.2f} "
           f"({rep['detect_black_squares_ms']:.1f} ms)")
    quad = ax.pattern_quad(gray, sheets[0])
    _, ipts, _ = ax.orient_and_fit_homography(gray, quad, cents, K, dist)
    obj = ev.board_object_points()
    rv0, tv0 = calib.solve_pnp(obj, ipts, K, dist, device=dev)
    refined = {}
    for name, d, route in (("graph", dev, None), ("eager", dev, "eager"),
                           ("cpu", cpu, None)):
        if name == "eager" and dev.type != "cuda":
            continue
        refined[name], sec = timed_s(lambda: ax.photometric_refine(
            gray, K, dist, rv0, tv0, 115.0, iters=iters, device=d,
            route=route), torch, dev)
        rep[f"refine_{name}_ms_per_step"] = sec * 1e3 / max(iters, 1)
    if "eager" in refined:
        expect(all(np.array_equal(a, b) for a, b in
                   zip(refined["graph"], refined["eager"])),
               f"cam1: {iters} photometric_refine steps replayed from the "
               "CUDA graph bit-equal to the eager steps (pose and loss)")
    (rv_g, tv_g, L_g), (rv_c, tv_c, L_c) = refined["graph"], refined["cpu"]
    d_rad = float(np.abs(rv_g - rv_c).max())
    d_mm = float(np.abs(tv_g - tv_c).max())
    rep["refine_card_vs_cpu"] = {"rad": d_rad, "mm": d_mm,
                                 "loss_rtol": rel_err(L_g, L_c)}
    expect(d_rad <= EXT_REFINE_RAD and d_mm <= EXT_REFINE_MM,
           f"cam1: photometric_refine on {dev.type} and the CPU within "
           f"{d_rad:.1e} rad and {d_mm:.1e} mm (<= {EXT_REFINE_RAD}, "
           f"{EXT_REFINE_MM}); loss rtol {rel_err(L_g, L_c):.1e}; ms/step "
           + ", ".join(f"{k} {rep[f'refine_{k}_ms_per_step']:.3f}"
                       for k in refined))
    part("cam1 checks")

    # the vote, card vs CPU, on the recovered poses with camera 2 flipped
    cand = [(c.rvec, c.tvec) for c in res.cameras]
    cand[1] = ax.flip_pose_180(*cand[1])
    bgs = [ax.median_background(b) for b in sc.backs]
    votes = {}
    for side, d in sides:
        masks = ax.quick_person_masks(bgs, sc.person, device=d)
        (flips, v), sec = timed_s(lambda: ax.resolve_rig_orientation(
            truth, cand, masks, device=d), torch, dev)
        votes[side] = (masks, flips, v, sec)
    (m_d, f_d, v_d, vote_s), (m_c, f_c, v_c, _) = votes["card"], votes["cpu"]
    rep["vote_s"] = vote_s
    expect(np.array_equal(m_d, m_c) and f_d == f_c and v_d == v_c
           and f_d == [False, True] + [False] * (n_cams - 2),
           f"quick_person_masks and resolve_rig_orientation on {dev.type} "
           f"and on the CPU: masks, votes and flips equal; camera 2's "
           f"flipped candidate flipped back ({vote_s:.2f} s, votes "
           f"{sorted(v_d.values(), reverse=True)})")
    part("vote")

    # -- 3. extrinsics_eval ------------------------------------------------
    aligned = [((ax.flip_pose_180(c.rvec, c.tvec)) if flipped
                else (c.rvec, c.tvec)) for c in res.cameras]
    committed = [(c.rvec, c.tvec) for c in truth]
    grays = [ax.temporal_mean_gray(b) for b in sc.boards]
    reps = {side: ev.evaluate_pose_sets(grays, truth, aligned, committed,
                                        device=d) for side, d in sides}
    ra, rb = reps["card"]
    ca, cb_ = reps["cpu"]
    rms_err = max(rel_err(ra.reproj_rms_px, ca.reproj_rms_px),
                  rel_err(rb.reproj_rms_px, cb_.reproj_rms_px),
                  rel_err(ra.triangulation_rms_mm, ca.triangulation_rms_mm),
                  rel_err(rb.triangulation_rms_mm, cb_.triangulation_rms_mm))
    rep["geometric"] = {"recovered": dataclasses.asdict(ra),
                        "committed": dataclasses.asdict(rb),
                        "card_vs_cpu_rtol": rms_err}
    expect(ra.kept_corners == ca.kept_corners and rms_err <= 1e-6,
           f"evaluate_pose_sets(recovered, committed) on {dev.type} and "
           f"the CPU: kept corners {ra.kept_corners} equal, RMS within rtol "
           f"{rms_err:.1e}; reprojection px recovered "
           f"{np.round(ra.reproj_rms_px, 3).tolist()}, committed "
           f"{np.round(rb.reproj_rms_px, 3).tolist()}; triangulation "
           f"{ra.triangulation_rms_mm:.3f} / {rb.triangulation_rms_mm:.3f} mm")
    part("evaluate_pose_sets")
    grid = GridConfig(nx=ab_grid, ny=ab_grid, nz=ab_grid)
    sil_u8 = sc.sils.astype(np.uint8) * 255
    occ = {side: ev.hull_coverage(sil_u8, truth, grid, device=d)
           for side, d in sides}
    expect(np.array_equal(occ["card"][0], occ["cpu"][0])
           and occ["card"][1] == occ["cpu"][1],
           f"hull_coverage at {ab_grid}^3 under the committed poses on "
           f"{dev.type} and the CPU: occupancy ({int(occ['cpu'][0].sum())} "
           f"voxels) and coverages {np.round(occ['cpu'][1], 4).tolist()} "
           "equal")
    ab = []
    for c in range(n_cams):
        flip = list(committed)
        flip[c] = ax.flip_pose_180(*flip[c])
        r_d, r_c = (ev.carve_silhouette_ab(sil_u8, truth, committed, flip,
                                           grid, device=d)
                    for d in (dev, cpu))
        expect(r_d == r_c and np.mean(r_d.coverage_b) < np.mean(
            r_d.coverage_a) and r_d.voxels_b < r_d.voxels_a,
               f"carve_silhouette_ab, camera {c + 1} flipped: reports equal "
               f"on {dev.type} and the CPU; mean coverage "
               f"{np.mean(r_d.coverage_a):.4f} -> "
               f"{np.mean(r_d.coverage_b):.4f}, hull voxels {r_d.voxels_a} "
               f"-> {r_d.voxels_b}")
        ab.append(dataclasses.asdict(r_d))
    rep["carve_ab"] = ab
    part("carve_silhouette_ab")

    # -- 4. MOG2 and KNN on phase 10's sequences ---------------------------
    T, H, W = bg_seqs[0].shape[:3]
    mog = {}
    for c, seq in enumerate(bg_seqs):
        mog[c], sec = timed_s(lambda: gmm.train_mog2(seq, device=dev),
                              torch, dev)
        rep.setdefault("mog2_ms_per_frame", []).append(sec * 1e3 / T)
    rows = slice(max(H // 2 - EXT_MOG2_ROWS // 2, 0),
                 H // 2 + EXT_MOG2_ROWS // 2)
    band = gmm.train_mog2(bg_seqs[0][:, rows], device=cpu)
    expect(all(torch.equal(getattr(mog[0], f)[rows].cpu(), getattr(band, f))
               for f in ("weight", "mean", "var", "nmodes"))
           and int(mog[0].nframes) == int(band.nframes) == T,
           f"train_mog2 over {T} frames: camera 1's rows {rows.start}-"
           f"{rows.stop - 1} bit-equal on {dev.type} and the CPU (weight, "
           f"mean, var, nmodes); modes per pixel up to "
           f"{int(mog[0].nmodes.max())}")
    m2 = gmm.extract_mask_mog2(mog[0], frames[0])
    m2_c = gmm.extract_mask_mog2(band, frames[0][rows])
    expect(torch.equal(m2[rows].cpu(), m2_c),
           f"extract_mask_mog2 on camera 1's rows: masks bit-equal "
           f"({float((m2 > 0).float().mean()):.4f} foreground)")
    kp = gmm.KNNParams()
    n_fill = min(kp.n_samples, T)
    fill = {side: gmm.train_knn(bg_seqs[0][:n_fill], device=d)
            for side, d in sides}
    expect(torch.equal(fill["card"].samples.cpu(), fill["cpu"].samples),
           f"train_knn over the first {n_fill} frames (the round-robin "
           f"fill): samples bit-equal on {dev.type} and the CPU")
    knn = {}
    for c, seq in enumerate(bg_seqs):
        knn[c], sec = timed_s(lambda: gmm.train_knn(seq, device=dev), torch,
                              dev)
        rep.setdefault("knn_ms_per_frame", []).append(sec * 1e3 / T)
    carried = gmm.KNNState(samples=knn[0].samples.cpu(),
                           n_seen=knn[0].n_seen.cpu(),
                           generator=torch.Generator())
    k_d = gmm.extract_mask_knn(knn[0], frames[0])
    expect(torch.equal(k_d.cpu(), gmm.extract_mask_knn(carried, frames[0])),
           f"apply_knn on the card's state after {T} frames carried to the "
           f"CPU: masks bit-equal ({float((k_d > 0).float().mean()):.4f} "
           "foreground)")
    print(f"  update ms/frame at {W}x{H}: MOG2 "
          f"{np.round(rep['mog2_ms_per_frame'], 3).tolist()}, KNN "
          f"{np.round(rep['knn_ms_per_frame'], 3).tolist()}")
    part("mog2 knn")

    # -- raw_masks_batched and BackgroundPipeline ---------------------------
    stacked = background.stack_states(tr_states)
    f_d = torch.from_numpy(frames).to(dev)
    raw = background.raw_masks_batched(stacked, f_d, mask_params, tr_params)
    raw_c = background.raw_masks_batched(
        gmm.MOGState(*(t.cpu() for t in stacked)), torch.from_numpy(frames),
        mask_params, tr_params)
    expect(torch.equal(raw.cpu(), raw_c),
           f"raw_masks_batched over {len(frames)} cameras on {dev.type} "
           "and on the CPU equal")
    if keep is not None:  # the reference's comparison grid, on one frame
        keep["masks"] = {
            "KNN": np.stack([gmm.extract_mask_knn(knn[c], frames[c]).cpu()
                             .numpy() for c in range(len(frames))]),
            "MOG": raw.cpu().numpy(),
            "MOG2": np.stack([gmm.extract_mask_mog2(mog[c], frames[c]).cpu()
                              .numpy() for c in range(len(frames))])}
    pipes = {
        "frames": (background.BackgroundPipeline(
            num_cameras=len(bg_seqs), mask_params=mask_params,
            background_frames=bg_seqs, device=dev), tr_states, frames),
        "npz": (background.BackgroundPipeline(
            None, num_cameras=len(seeded_states), mask_params=mask_params,
            cache_dir=models_dir, device=dev),
            [gmm.MOGState(*(t.to(dev) for t in s)) for s in seeded_states],
            rig_frame),
    }
    for name, (pipe, states, fr) in pipes.items():
        got = pipe.masks_for_frames(fr)
        want = np.stack([background.extract_foreground_mask(
            states[c], fr[c], mask_params[c], pipe.mog_params[c],
            ccl_backend="host").cpu().numpy() for c in range(len(fr))])
        expect(np.array_equal(got, want),
               f"BackgroundPipeline from {name}: masks_for_frames equal to "
               f"the per-camera calls on the {name} states "
               f"({float((got > 0).mean()):.4f} foreground)")
    part("pipelines")
    rep["split_s"] = split
    print("  phase 20 by part (s): " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in split.items()))
    rep["peak_gb"] = peak_gb(torch, dev)
    rep["seconds"] = time.perf_counter() - t_phase
    return rep


SHARD_COUNTS = (2, 4, 8)  # phase 21's emulated shard counts on one card
SHARD_ORDERS = ("contiguous", "strided", "cost")


def emulate_shards(torch, dev, flush, btab, masks, image, vt, what,
                   shard_counts=SHARD_COUNTS, hold_plain=True):
    """Phase 21(b) on one grid: at each shard count and superblock order,
    every shard's local program on this card (``local_table_slice`` of
    ``btab`` + all C ``masks`` → kernel K1, each shard held against K1's
    plain version where ``hold_plain``); the union of the shards,
    unshuffled, bit-equal to the unsharded K1.  Returns the report: the
    unsharded K1 ms and per count and order the shards' K1 ms (max, mean)
    and the predicted imbalance of ``superblock_costs``."""
    from vbr_tpu_torch.ops import carve_blocked as cb
    from vbr_tpu_torch.parallel import pallas_sharded as ps

    kw = dict(color_camera=btab.color_camera, views_threshold=vt)

    def k1_args(t):
        active, full = cb.block_activity(masks, vt, t.allv, t.ry, t.rx)
        return (t.pk, t.lcc, active, full, masks, image)

    whole = k1_args(btab)
    want = cb.carve_blocked_kernel(*whole, **kw)
    whole_ms = timed_ms(lambda: cb.carve_blocked_kernel(*whole, **kw), torch,
                        dev, reps=5, flush=flush)
    costs = ps.superblock_costs(btab, masks, vt)
    report = {"grid": list(btab.grid_shape), "cameras": btab.num_cameras,
              "nsuper": btab.nsuper, "whole_k1_ms": whole_ms, "shards": {}}
    err = 0.0
    print(f"  [21b] {what}: unsharded K1 {whole_ms:.4f} ms over "
          f"{btab.nsuper} superblocks", flush=True)
    for S in shard_counts:
        for mode in SHARD_ORDERS:
            order = ps.superblock_order(
                btab.nsuper, S, mode, costs=costs if mode == "cost" else None)
            parts, ms = [], []
            for k in range(S):
                args = k1_args(ps.local_table_slice(btab, k, S, order))
                got = cb.carve_blocked_kernel(*args, **kw)
                if hold_plain:
                    plain = cb.carve_blocked_plain(*args, **kw)
                    expect(all(torch.equal(a, b) for a, b in zip(got, plain)),
                           f"{what}: shard {k} of {S} ({mode}) K1 bit-equal "
                           "to its plain version")
                    err = max(err, max_abs_err(zip(got, plain)))
                ms.append(timed_ms(lambda: cb.carve_blocked_kernel(*args, **kw),
                                   torch, dev, reps=5, flush=flush))
                parts.append(got)
                del args
            occ_u, col_u = ps.unshuffle_blocked(
                torch.cat([o for o, _ in parts])[None],
                torch.cat([c for _, c in parts])[None], btab, order)
            del parts
            expect(torch.equal(occ_u[0], want[0])
                   and torch.equal(col_u[0], want[1]),
                   f"{what}: the union of {S} shards ({mode}) equals the "
                   "unsharded K1 bit for bit")
            del occ_u, col_u
            c = np.zeros(len(order))
            c[:btab.nsuper] = costs
            per = c[order].reshape(S, -1).sum(axis=1)
            row = {"max_ms": max(ms), "mean_ms": float(np.mean(ms)),
                   "predicted_imbalance": float(per.max() / per.mean())}
            report["shards"][f"{S}/{mode}"] = row
            print(f"    {S} shards, {mode:10s}: K1 per shard max "
                  f"{row['max_ms']:.4f} ms, mean {row['mean_ms']:.4f} ms "
                  f"(predicted imbalance {row['predicted_imbalance']:.3f})")
    return report, err


def sharded_phase(torch, dev, kernels, flush, rig, stretch=None):
    """Phase 21: the sharded production step (see ``run``) on phase 14's
    rig models and frames ``rig``, and the emulated shards also on phase
    18's largest tables ``stretch`` (a dict, when it kept them).  Returns
    its report and the max abs error of the shards' K1 and K2 against
    their plain versions."""
    import tempfile

    import torch.distributed as dist

    from vbr_tpu_torch.ops import carve as carve_ops
    from vbr_tpu_torch.ops import ccl, ccl_label, gmm, morphology
    from vbr_tpu_torch.ops import marching_cubes as mc
    from vbr_tpu_torch.ops.color import bgr_to_hsv_u8
    from vbr_tpu_torch.parallel import (carve_sharded, mesh_sharded,
                                        pallas_sharded, pipeline_sharded)
    from vbr_tpu_torch.pipelines import background

    model, frames = rig.model, rig.frames
    vt, cc = model.rig.views_threshold, model.rig.color_camera
    report = {}
    ref = [model.process_frame_fast(f, layout="blocked") for f in frames]
    sync(torch, dev)

    # -- [21a] one rank, through the real runner ---------------------------
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, no peers
    store = tempfile.mkdtemp(prefix="vbr_store_")
    t0 = time.perf_counter()
    carve_sharded.init_rank_group(os.path.join(store, "store"),
                                  device=dev.type)
    try:
        mesh = carve_sharded.make_carve_mesh(num_cameras=4, frame_batch=1,
                                             device=dev.type)
        backend = dist.get_backend()
        print(f"  [21a] one-rank {backend} group and mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        expect(tuple(mesh.shape) == (1, 1, 1), f"mesh {mesh.shape}")
        batches = [f[None] for f in frames]
        runner_launches, runner_ms = {}, {}
        for mode in SHARD_ORDERS:
            runner = model.sharded_runner(
                mesh, order=mode,
                costing_frames=frames[0] if mode == "cost" else None)
            for k in kernels:
                k.launches = 0
            outs = [runner(b) for b in batches]
            sync(torch, dev)
            launches = {k.source.stem: k.launches for k in kernels}
            streamed = list(runner.stream(iter(batches), depth=2))
            replaced = runner.rebalance(frames[4], min_gain=0.0)
            after = runner(batches[4])
            same = all(np.array_equal(o[0][0], r[0].cpu().numpy())
                       and np.array_equal(o[1][0], r[1].cpu().numpy())
                       for o, r in zip(outs, ref))
            same_stream = all(
                np.array_equal(s[0], o[0]) and np.array_equal(s[1], o[1])
                for s, o in zip(streamed, outs))
            expect(same and same_stream and len(streamed) == len(outs)
                   and np.array_equal(after[0], outs[4][0])
                   and np.array_equal(after[1], outs[4][1])
                   and (dev.type == "cpu"
                        or launches["carve_blocked"] >= len(frames)
                        <= launches["ccl_combined"]),
                   f"ShardedRunner(order={mode!r}) on {len(frames)} rig "
                   "frames equal to process_frame_fast(layout='blocked') bit "
                   "for bit, through __call__ and stream(depth=2), and after "
                   f"a rebalance (re-placed: {replaced}); launches {launches}")
            runner_launches[mode] = launches
            # the step's overflow bits against the single-device step's
            step_out = runner._step(
                pallas_sharded.place_frames(mesh, batches[0]),
                *runner._static_in, runner._st.tables)
            _, _, ovf1 = model._step(model._frames(frames[0]), "blocked",
                                     "blocked")
            expect(torch.equal(step_out[2][0].cpu(), ovf1.cpu()),
                   f"sharded step overflow bits {step_out[2].tolist()} equal "
                   "the single-device step's")
            runner_ms[mode] = timed_ms(lambda: runner(batches[0]), torch, dev,
                                       reps=10)
        fast_ms = timed_ms(
            lambda: [x.cpu() for x in model.process_frame_fast(
                frames[0], layout="blocked")], torch, dev, reps=10)
        print(f"  runner ms/frame (one rank, host clock to numpy): "
              f"{runner_ms}; process_frame_fast + download {fast_ms:.3f}")
        report["runner"] = {"launches": runner_launches, "ms": runner_ms,
                            "process_frame_fast_ms": fast_ms,
                            "backend": backend}

        occ0 = carve_ops.to_host(model.process_frame_fast(frames[0])[0])
        vol = occ0.reshape(model.grid.shape)
        tris_s, n_s = mesh_sharded.extract_mesh_sharded(vol, mesh)
        tris_r, n_r = mc.extract_mesh(vol, device=dev)
        expect(n_s == n_r > 0 and np.array_equal(tris_s, tris_r),
               f"extract_mesh_sharded equals extract_mesh ({n_r} triangles)")

        t = model.tables
        masks0 = model.masks(frames[0])
        frames0 = torch.from_numpy(frames[0]).to(dev)
        occ_s, col_s = carve_sharded.sharded_carve_step(
            mesh, views_threshold=vt, color_camera=cc)(
            *carve_sharded.shard_inputs(mesh, masks0[None], frames[0:1],
                                        t.valid, t.lin_idx))
        occ_t, col_t = carve_ops.carve_from_tables(
            masks0, frames0, t.valid, t.lin_idx, views_threshold=vt,
            color_camera=cc)
        expect(torch.equal(occ_s[0], occ_t) and torch.equal(col_s[0], col_t),
               f"sharded_carve_step equals carve_from_tables "
               f"({int(occ_t.sum())} occupied)")

        states = model.bg_states
        w, mu, var = (torch.stack([getattr(s, f).to(dev) for s in states])
                      for f in ("weight", "mean", "var"))
        hsv0 = bgr_to_hsv_u8(frames0)
        p = model.mog_params[0]
        fig = [m.figure_threshold for m in model.mask_params]
        inner = [m.inner_threshold for m in model.mask_params]
        pipe = {}
        for clean in (False, True):
            thr = dict(fig_thr=fig, inner_thr=inner) if clean else {}
            occ_p = pipeline_sharded.sharded_pipeline_step(
                mesh, views_threshold=vt, mog_params=p, clean=clean)(
                *pipeline_sharded.place_pipeline_inputs(
                    mesh, hsv0[None], w, mu, var, t.valid, t.lin_idx, **thr))
            ms = []
            for c in range(len(states)):
                m = morphology.opening(gmm.apply_frozen(
                    gmm.MOGState(w[c], mu[c], var[c], states[c].nframes),
                    hsv0[c], p), (3, 3))
                ms.append(ccl.clean_mask(m, fig[c], inner[c]) if clean else m)
            occ_r, _ = carve_ops.carve_from_tables(
                torch.stack(ms), frames0, t.valid, t.lin_idx,
                views_threshold=vt, color_camera=cc)
            pipe[clean] = int(occ_r.sum())
            expect(torch.equal(occ_p[0], occ_r),
                   f"sharded_pipeline_step(clean={clean}) equals the "
                   f"one-device apply, opening{', cleanup' if clean else ''} "
                   f"and table carve ({pipe[clean]} occupied)")
        del w, mu, var
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # -- [21b] 2, 4 and 8 shards on one card --------------------------------
    frame_d = torch.from_numpy(frames[0]).to(dev)
    image = frame_d[cc].contiguous()
    emul, k1_err = emulate_shards(torch, dev, flush, model._btab, masks0,
                                  image, vt, f"the rig at {model.grid.shape}")
    report["emulated"] = [emul]
    if stretch is not None:
        big, _ = emulate_shards(
            torch, dev, flush, stretch["btab"], stretch["masks"],
            stretch["image"], stretch["views_threshold"],
            f"{stretch['btab'].num_cameras} cameras at "
            f"{stretch['btab'].grid_shape}", hold_plain=False)
        report["emulated"].append(big)
    # the shard-local mask stage: K2 on C/cam images per launch
    raw = background.raw_masks_batched_fz(model._stacked_fz, frame_d,
                                          model.mask_params)
    C, H, W = raw.shape
    Hp, Wp = ccl._pad_to_tiles(H, W)
    phase = torch.zeros((C, Hp, Wp), dtype=torch.bool, device=dev)
    phase[:, :H, :W] = raw > 0
    plain = ccl_label.label_components_combined_plain(phase.cpu())
    k2_err = 0.0
    for cam in (1, 2, 4):
        per = C // cam
        for j in range(cam):
            got = ccl_label.label_components_combined(
                phase[j * per:(j + 1) * per])
            want = [x[j * per:(j + 1) * per] for x in plain]
            k2_err = max(k2_err, max_abs_err(
                (g.cpu(), w_) for g, w_ in zip(got, want)))
            expect(all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want)),
                   f"K2 on {per} image(s) (cam = {cam}, shard {j}) equals "
                   "its plain version on the CPU")
    report["k2_images_per_launch"] = [C // cam for cam in (1, 2, 4)]
    return report, k1_err, k2_err


VIEWER_HW = (720, 960)  # ``headless.render_points``' default image
VIEWER_POINTS = 2_200_000  # ``gl_engine.InstancedCubes``' max_instances
VIEWER_GRID = 128  # ``AppConfig``'s world: 128 x (64 * 2) x 128
# ``vbr_tpu/apps/cli.py`` ``orbit_pose``: radius, height and target, and
# the first angle of the ``--animate`` orbit
ORBIT_RADIUS, ORBIT_HEIGHT, ORBIT_TARGET = 38.0, 24.0, (4.0, 6.0, 0.0)
ORBIT_START = -135.0
VIEWER_REPS = 5  # timed runs of each render


def orbit_eye(theta_deg):
    """The eye that ``orbit_pose(theta_deg)`` places."""
    th = np.radians(theta_deg)
    return (ORBIT_TARGET[0] + ORBIT_RADIUS * np.cos(th), ORBIT_HEIGHT,
            ORBIT_TARGET[2] + ORBIT_RADIUS * np.sin(th))


def gl_packages():
    """Whether each package of the GL viewer imports on this host, each in
    a process of its own: {module: "yes" or the error's last line}."""
    out = {}
    for name in ("OpenGL.GL", "glfw", "PIL.Image"):
        res = subprocess.run([sys.executable, "-c", f"import {name}"],
                             capture_output=True, text=True, timeout=120)
        out[name] = ("yes" if res.returncode == 0
                     else (res.stderr.strip().splitlines() or ["no"])[-1])
    return out


def viewer_render_phase(torch, dev, rig, image_hw, grid_edge=VIEWER_GRID,
                        hw=VIEWER_HW, n_points=VIEWER_POINTS,
                        build_root="build"):
    """Phase 22: the viewer's headless renderer on ``dev`` (see ``run``),
    each image held bit-equal to the same call on the CPU.  Returns its
    report."""
    from itertools import cycle

    from vbr_tpu_torch.ops import carve as carve_ops
    from vbr_tpu_torch.pipelines import reconstruction
    from vbr_tpu_torch.pipelines.background import BackgroundPipeline
    from vbr_tpu_torch.utils.config import CameraParams, GridConfig, RigConfig
    from vbr_tpu_torch.utils.video import ArraySource
    from vbr_tpu_torch.viewer import app, headless

    t_phase = time.perf_counter()
    H, W = image_hw
    grid = GridConfig(nx=grid_edge, ny=grid_edge, nz=grid_edge)
    cams = [CameraParams.from_arrays(*c) for c in rig_cameras(image_hw)]
    # the viewer's state as ``run_viewer`` makes it, on the rig's models
    # and frames: frame 0 once ahead of the 8 (the timing's warm-up)
    t0 = time.perf_counter()
    state = app.ViewerState(
        source=ArraySource(np.concatenate([rig.frames[:1], rig.frames])),
        background=BackgroundPipeline(None, cache_dir=rig.models,
                                      mask_params=rig.model.mask_params,
                                      device=dev),
        recon=reconstruction.Reconstructor(
            cams, grid, RigConfig(image_height=H, image_width=W),
            device=dev))
    print(f"  the viewer's state on {dev.type} (the rig's models loaded) in "
          f"{time.perf_counter() - t0:.2f} s")
    # the scene furniture as the CLI's render passes it
    floor_pos, floor_col = reconstruction.generate_grid(64, 64)
    cam_pos, cam_col = reconstruction.get_cam_positions(cams)
    furniture = (np.asarray(floor_pos), np.asarray(floor_col),
                 np.asarray(cam_pos, float), cam_col)
    eyes = [orbit_eye(ORBIT_START + 360.0 * i / RIG_FRAMES)
            for i in range(RIG_FRAMES)]

    def draw(pos, rgb, eye, device):
        img = headless.render_points(pos, rgb, eye=eye, target=ORBIT_TARGET,
                                     image_hw=hw, device=device)
        return headless.render_floor_and_cameras(img, *furniture, eye=eye,
                                                 target=ORBIT_TARGET)

    def cpu_draw(pos, rgb, eye, times):
        """``draw`` on the CPU, its host-clock ms appended to ``times``."""
        t0 = time.perf_counter()
        img = draw(pos, rgb, eye, "cpu")
        times.append((time.perf_counter() - t0) * 1e3)
        return img

    # -- the viewer's G key along the orbit: ``app.recarve`` (masks, carve,
    # compaction) and the render, to the image on the host, timed frame by
    # frame (the warm-up's frame 0 first); then each image against the CPU
    shown = []

    def whole_frame(i):
        pos, rgb = app.recarve(state)
        shown.append((pos, rgb, draw(pos, rgb, eyes[i], dev).cpu()))

    order = iter([0, *range(RIG_FRAMES)])
    frame_ms = timed_ms(whole_frame, torch, dev, reps=RIG_FRAMES,
                        setup=lambda: next(order))
    shown = shown[1:]
    n_occ, covered, same, cpu_hull = [], [], True, []
    empty = np.zeros((0, 3), np.float32)
    for i, (pos, rgb, img) in enumerate(shown):
        same &= (img.shape == (hw[0], hw[1], 3) and img.dtype == torch.uint8
                 and torch.equal(img, cpu_draw(pos, rgb, eyes[i], cpu_hull)))
        covered.append(int((img != draw(empty, empty, eyes[i], "cpu"))
                           .any(-1).sum()))
        n_occ.append(len(pos))
    expect(same and min(n_occ) > 0 and min(covered) > 0
           and app.recarve(state) is None,
           f"the viewer's recarve on the rig at {grid_edge}^3 over "
           f"{RIG_FRAMES} frames, then None, rendered at {hw[1]}x{hw[0]} "
           f"with the floor and the cameras along the orbit (radius "
           f"{ORBIT_RADIUS}, height {ORBIT_HEIGHT}, from {ORBIT_START} "
           f"degrees): every image bit-equal on {dev.type} and on the CPU; "
           f"voxels {n_occ}, pixels the hull covers {covered}")
    img0 = shown[0][2]
    png = os.path.join(build_root, "viewer_frame0.png")
    headless.save_png(png, img0)
    expect(np.array_equal(read_png(png), img0.numpy()),
           f"save_png of frame 0 ({os.path.getsize(png)} B) read back by the "
           "standard-library decoder equals the image")

    # -- the viewer's capacity: seeded points of the lattice, repeats and
    # tied depths included
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, grid_edge ** 3, n_points)
    pos_c, rgb_c = carve_ops.viewer_arrays(
        grid.voxel_points()[idx],
        rng.integers(0, 256, (n_points, 3), dtype=np.uint8),
        state.recon.rig.scaling_factor)
    R, t = headless.look_at(eyes[0], ORBIT_TARGET)
    z = headless._camera_frame(torch.from_numpy(pos_c).double(), R, t)[2]
    tied = int((torch.unique(z, return_counts=True)[1] > 1).sum())
    pos_d = torch.from_numpy(pos_c).to(dev)
    rgb_d = torch.from_numpy(rgb_c).to(dev)
    img = draw(pos_d, rgb_d, eyes[0], dev).cpu()
    cpu_cap = []
    want = [cpu_draw(pos_c, rgb_c, eyes[0], cpu_cap)
            for _ in range(VIEWER_REPS)][0]
    expect(torch.equal(img, want),
           f"{n_points} seeded points of the {grid_edge}^3 lattice "
           f"({n_points - len(np.unique(idx))} repeats, {tied} depth values "
           f"shared by more than one point) rendered at {hw[1]}x{hw[0]}: "
           f"image bit-equal on {dev.type} and on the CPU")

    # -- times: device-event intervals on the card (where a function waits
    # for the host, as the mask stage and the download do, the wait is
    # inside), the host clock on the CPU (the comparisons' runs above)
    uploaded = [(torch.from_numpy(p).to(dev), torch.from_numpy(c).to(dev),
                 eyes[i]) for i, (p, c, _) in enumerate(shown)]
    hull = cycle(uploaded)
    reps = max(VIEWER_REPS, RIG_FRAMES)
    fr0 = rig.frames[0]
    masks0 = state.background.masks_for_frames(fr0)
    occ, col = state.recon.carve_frame(masks0, fr0)
    ms = {
        "render_rig_hull": timed_ms(lambda a: draw(*a, dev), torch, dev,
                                    reps=reps, setup=lambda: next(hull)),
        "render_capacity": timed_ms(
            lambda: draw(pos_d, rgb_d, eyes[0], dev), torch, dev,
            reps=VIEWER_REPS),
        "frame": frame_ms,
        "masks": timed_ms(lambda: state.background.masks_for_frames(fr0),
                          torch, dev, reps=VIEWER_REPS),
        "carve": timed_ms(lambda: state.recon.carve_frame(masks0, fr0),
                          torch, dev, reps=VIEWER_REPS),
        "compact": timed_ms(lambda: carve_ops.compact_voxels(
            occ, col, grid, state.recon.rig.scaling_factor), torch, dev,
            reps=VIEWER_REPS),
        "cpu_render_rig_hull": float(np.median(cpu_hull)),
        "cpu_render_capacity": float(np.median(cpu_cap)),
    }
    clock = "device-event" if dev.type == "cuda" else "host-clock"
    print(f"  render ms per frame on {dev.type} (median of {reps} {clock} "
          f"intervals): the rig hull {ms['render_rig_hull']:.3f} "
          f"({np.mean(n_occ):.0f} voxels on average), {n_points} points "
          f"{ms['render_capacity']:.3f} (median of {VIEWER_REPS})")
    print(f"  the CPU torch render, the host's pace (median of "
          f"{RIG_FRAMES} and {VIEWER_REPS} host-clock intervals): the rig hull "
          f"{ms['cpu_render_rig_hull']:.3f} ms, {n_points} points "
          f"{ms['cpu_render_capacity']:.3f} ms")
    print(f"  the whole frame (app.recarve: masks, carve, compaction; the "
          f"render and the image's download; median of {RIG_FRAMES}) "
          f"{ms['frame']:.3f} ms; apart (median of {VIEWER_REPS}): masks "
          f"{ms['masks']:.3f}, carve {ms['carve']:.3f}, compaction "
          f"{ms['compact']:.3f}, render {ms['render_rig_hull']:.3f}: the "
          f"render's share {ms['render_rig_hull'] / ms['frame']:.3f}")
    profiles = {}
    if dev.type == "cuda":
        for key, args, n in (("render_rig_hull", uploaded[0], 4),
                             ("render_capacity", (pos_d, rgb_d, eyes[0]),
                              2)):
            def render(a=args):
                draw(*a, dev)
                torch.cuda.synchronize()
            profiles[key] = profile_step(
                torch, render, ms[key],
                f"  profile of the {key} render ({n} renders):", frames=n)
    packages = gl_packages()
    print(f"  the GL viewer's packages on this host (information, not a "
          f"check): {packages}")
    return {"image_hw": list(hw), "grid": [grid_edge] * 3,
            "frames": RIG_FRAMES, "voxels": n_occ, "covered_pixels": covered,
            "points": n_points, "tied_depths": tied, "ms": ms,
            "profiles": profiles, "png_bytes": os.path.getsize(png),
            "gl_packages": packages,
            "seconds": time.perf_counter() - t_phase}


CLI_BG_FRAMES = 134  # background.avi frames per camera (the rig's, SURVEY.md)
CLI_VIDEO_FRAMES = 428  # video.avi frames per camera
CLI_FPS = 50.0
CLI_GRID = 128
CLI_OFFLINE_NF = 8  # ``pipeline --offline N``
CLI_BATCHED = 8  # ``carve --batched --frames N``
CLI_CPU_FRAMES = 4  # frames of ``pipeline`` on the CPU side
CLI_DECODE_FRAMES = 32  # frames decoded in sequence, timed, then stepped
CLI_WALK = (40, 3)  # px: the subject's walk across the frame and its bob
CLI_CALIB_VIEWS = 8  # cam1's board views of ``calibrate`` (intrinsics)
CLI_CALIB_SS = 2  # their supersampling per axis
CLI_BAD_FY = 1.08  # one more view with fy this much longer: ``--discard``
# drops it (removing it lowers the RMS by more than 0.15 px)


def card_line():
    """``nvidia-smi``'s name and power limit of the card (its first line),
    or None where it fails."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else None


def write_cli_rig(root, bg_frames, video_frames, seed=SEED + 23):
    """A rig directory as the CLI reads it, written by the port's own
    writers: ``cam{i}/config.xml`` (the cameras of ``RIG_DIR``),
    ``checkerboard.xml``, and per camera ``background.avi`` (a seeded
    textured background, ``rig_background``, plus ±4 levels of noise per
    pixel, 3 % of the pixels 50 levels brighter: one of 8 seeded noise
    fields per frame, rolled by a seeded offset) and ``video.avi`` (the
    rig's silhouettes in the subject texture over it, walking
    ``CLI_WALK[0]`` px across and bobbing ``CLI_WALK[1]`` px, 200 speckle
    pixels per camera), MJPEG at ``CLI_FPS``, one thread per camera
    painting and encoding its frames.  Returns the directory."""
    from vbr_tpu_torch.native import VideoSink
    from vbr_tpu_torch.utils import xmlio

    H, W = RIG_HW
    data = f"{root}/cli_rig_{H}x{W}_{bg_frames}_{video_frames}"
    shutil.rmtree(data, ignore_errors=True)
    for i, cam in enumerate(rig_cameras(RIG_HW), start=1):
        xmlio.save_camera_config(f"{data}/cam{i}", *cam)
    xmlio.save_storage(f"{data}/checkerboard.xml",
                       {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
                        "CheckerBoardSquareSize": 115})
    rng = np.random.default_rng(seed)
    sils = rig_silhouettes(RIG_HW)
    C = len(sils)
    bg = np.stack([rig_background(rng, RIG_HW) for _ in sils])
    tex = subject_texture(H, W)
    # noise fields drawn once; each frame adds one of them at a seeded
    # offset, so no two frames of a camera carry the same noise
    noise = rng.integers(-4, 5, (8,) + bg.shape, dtype=np.int8)
    noise[rng.random(noise.shape[:4]) < 0.03] = 50
    # every draw is made here, in one order; then each camera's thread
    # paints and encodes its own frames
    picks = [(rng.integers(0, len(noise)), rng.integers(0, W))
             for _ in range(bg_frames)]
    speckle = [(rng.integers(0, H, (C, 200)), rng.integers(0, W, (C, 200)))
               for _ in range(video_frames)]

    def write_camera(c):
        cam = f"{data}/cam{c + 1}"
        with VideoSink(f"{cam}/background.avi", CLI_FPS, W, H) as sink:
            for k, shift in picks:
                fr = bg[c] + np.roll(noise[k, c], shift, axis=1)
                sink.write(np.clip(fr, 0, 255).astype(np.uint8))
        with VideoSink(f"{cam}/video.avi", CLI_FPS, W, H) as sink:
            for t, (ys, xs) in enumerate(speckle):
                ph = t / max(video_frames - 1, 1)
                dx = int(round(CLI_WALK[0] * (ph - 0.5)))
                dy = int(round(CLI_WALK[1] * np.sin(2 * np.pi * 4 * ph)))
                sil = np.roll(sils[c], (dy, dx), axis=(0, 1))
                sil[ys[c], xs[c]] = True  # speckle
                fr = bg[c].copy()
                fr[sil] = tex[sil]
                sink.write(fr)

    with ThreadPoolExecutor(C) as pool:  # numpy and PIL free the GIL
        list(pool.map(write_camera, range(C)))
    return data


def run_cli(cli, argv):
    """``cli.main(argv)``; (its printed lines, host seconds).  The lines
    are printed again, indented."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"    | {ln}")
    return lines, s


class watch_training:
    """Times each ``VisualHull.train_background`` call (and keeps its model)
    while the CLI runs: ``calls`` of (seconds, model)."""

    def __init__(self, torch, dev):
        self.torch, self.dev, self.calls = torch, dev, []

    def __enter__(self):
        from vbr_tpu_torch.models.visual_hull import VisualHull

        self.orig = VisualHull.train_background
        orig = self.orig

        def train_background(model, source):
            t0 = time.perf_counter()
            orig(model, source)
            sync(self.torch, self.dev)
            self.calls.append((time.perf_counter() - t0, model))

        VisualHull.train_background = train_background
        return self

    def __exit__(self, *exc):
        from vbr_tpu_torch.models.visual_hull import VisualHull

        VisualHull.train_background = self.orig


class models_from:
    """``VisualHull.from_data_dir`` loading the background models of
    ``cache_dir`` in place of training them (the CPU side's ``pipeline``:
    the plain training of four cameras takes minutes on the host)."""

    def __init__(self, cache_dir):
        self.cache_dir = cache_dir

    def __enter__(self):
        from vbr_tpu_torch.models.visual_hull import VisualHull

        self.orig = VisualHull.__dict__["from_data_dir"]
        cache, orig = self.cache_dir, self.orig.__func__

        def load(cls, data_dir, grid=None, train_background=True, **kw):
            m = orig(cls, data_dir, grid, train_background=False, **kw)
            if not m.load_background_models(cache):
                raise FileNotFoundError(f"no background models in {cache}")
            return m

        VisualHull.from_data_dir = classmethod(load)
        return self

    def __exit__(self, *exc):
        from vbr_tpu_torch.models.visual_hull import VisualHull

        VisualHull.from_data_dir = self.orig


class record_steps:
    """Keeps what ``VisualHull``'s stream and offline steps return while
    the CLI runs: ``stream`` (occupancy, colours) per frame, on the model's
    device (the colours of the first ``keep_colors`` frames only, else
    None); ``offline`` (occupancy (F, N), the first ``keep_colors`` frames'
    colours) per call; ``entered`` the host clock at each stream step's
    call, so the gaps are the stream loop's period."""

    def __init__(self, keep_colors):
        self.keep = keep_colors
        self.stream, self.offline, self.entered = [], [], []

    def __enter__(self):
        from vbr_tpu_torch.models.visual_hull import VisualHull

        self.orig = (VisualHull.process_frame_fast,
                     VisualHull.process_frames_offline)
        fast, offline = self.orig

        def process_frame_fast(model, frames, *a, **kw):
            self.entered.append(time.perf_counter())
            occ, col = fast(model, frames, *a, **kw)
            keep = col.clone() if len(self.stream) < self.keep else None
            self.stream.append((occ.clone(), keep))
            return occ, col

        def process_frames_offline(model, frames, *a, **kw):
            occ, colors = offline(model, frames, *a, **kw)
            self.offline.append((occ.copy(), (colors or [])[:self.keep]))
            return occ, colors

        VisualHull.process_frame_fast = process_frame_fast
        VisualHull.process_frames_offline = process_frames_offline
        return self

    def __exit__(self, *exc):
        from vbr_tpu_torch.models.visual_hull import VisualHull

        (VisualHull.process_frame_fast,
         VisualHull.process_frames_offline) = self.orig


def same_colors(a, b):
    """Two lists of ``process_frames_offline``'s per-frame (idx, col)."""
    return len(a) == len(b) and all(
        np.array_equal(ia, ib) and np.array_equal(ca, cb)
        for (ia, ca), (ib, cb) in zip(a, b))


def same_files(a_dir, b_dir, names):
    """The names whose files differ (or are missing) between two
    directories."""
    bad = []
    for n in names:
        pa, pb = os.path.join(a_dir, n), os.path.join(b_dir, n)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            bad.append(n)
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                bad.append(n)
    return bad


def cli_phase(torch, dev, kernels, bg_frames=CLI_BG_FRAMES,
              video_frames=CLI_VIDEO_FRAMES, grid_edge=CLI_GRID,
              offline_nf=CLI_OFFLINE_NF, batched=CLI_BATCHED,
              cpu_frames=CLI_CPU_FRAMES, decode_frames=CLI_DECODE_FRAMES,
              ext_hw=RIG_HW, ext_cams=4, ext_bg_frames=EXT_BG_FRAMES,
              calib_views=CLI_CALIB_VIEWS, build_root="build"):
    """Phase 23: the CLI (``apps/cli.py``) on a rig directory of MJPEG
    videos at the rig's size (see ``run``), and ``calibrate`` of intrinsics
    on ``calib_views`` board views.  Returns its report."""
    from vbr_tpu_torch import native
    from vbr_tpu_torch.apps import cli
    from vbr_tpu_torch.ops import gmm
    from vbr_tpu_torch.utils import artifacts
    from vbr_tpu_torch.utils import video as vio
    from vbr_tpu_torch.utils.config import MOGParams

    t_phase = time.perf_counter()
    card = (card_line() or "no nvidia-smi") if dev.type == "cuda" else "cpu"
    H, W = RIG_HW
    t0 = time.perf_counter()
    data = write_cli_rig(build_root, bg_frames, video_frames)
    write_s = time.perf_counter() - t0
    size_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                  os.walk(data) for f in fs) / 1e6
    print(f"  rig directory written in {write_s:.2f} s ({size_mb:.1f} MB: "
          f"4 x {bg_frames} background and {video_frames} video frames, "
          f"MJPEG {W}x{H})")

    # -- the reader's forms and the container's counts ---------------------
    videos = [f"{data}/cam{c}/{n}" for c in range(1, 5)
              for n in ("background.avi", "video.avi")]
    for p in videos:
        want = bg_frames if p.endswith("background.avi") else video_frames
        expect(vio.video_properties(p) == (W, H, want),
               f"{p[len(data) + 1:]}: the container's count "
               f"{vio.video_properties(p)[2]} frames of {W}x{H}")
    cam1 = f"{data}/cam1/video.avi"
    every = vio.read_video(cam1)
    expect(len(every) == video_frames, f"cam1/video.avi decodes to "
           f"{len(every)} frames, the container's count")
    it_ok = all(np.array_equal(a, b) for a, b in
                zip(vio.frame_iterator(cam1), every))
    picks = sorted({0, video_frames // 2, video_frames - 1})
    get_ok = all(np.array_equal(vio.get_frame(cam1, i), every[i])
                 for i in picks) and vio.get_frame(cam1, video_frames) is None

    # -- host decode (PrefetchingSource's camera 1 is the fourth form) ------
    src = vio.MultiCameraSource(data)
    n_dec = min(decode_frames, video_frames)
    t0 = time.perf_counter()
    held = [src.next_frames() for _ in range(n_dec)]
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
    src.release()
    pre = native.PrefetchingSource([f"{data}/cam{c}/video.avi"
                                    for c in range(1, 5)])
    t0 = time.perf_counter()
    n_pre, pre_ok = 0, True
    while (f := pre.next_frames()) is not None:
        pre_ok &= n_pre < video_frames and np.array_equal(f[0], every[n_pre])
        n_pre += 1
    prefetch_ms = (time.perf_counter() - t0) * 1e3 / max(n_pre, 1)
    pre.close()
    expect(it_ok and get_ok and pre_ok and n_pre == video_frames,
           "read_video, frame_iterator, get_frame (frames "
           f"{picks}, None past the end) and PrefetchingSource give the "
           "same frames")
    del every
    print(f"  host decode of a 4-camera frame: {decode_ms:.3f} ms "
          f"(MultiCameraSource, one thread, {n_dec} frames), "
          f"{prefetch_ms:.3f} ms per frame through PrefetchingSource (4 "
          f"threads, {n_pre} frames); {card}")

    # -- the commands on the device ----------------------------------------
    out_d = os.path.abspath(f"{build_root}/cli_out_{dev.type}")
    out_c = os.path.abspath(f"{build_root}/cli_out_cpu_side")
    for d in (out_d, out_c):
        shutil.rmtree(d, ignore_errors=True)
    # ``pipeline`` and ``masks`` each train from video, ``masks`` writes
    # the cache the later commands and the CPU side load
    g = str(grid_edge)
    common = ["--data", data, "--out-dir", out_d]
    commands = {
        "pipeline": ["pipeline", "--grid", g, "--frames", "0", "--ply",
                     f"{out_d}/stream.ply"],
        "pipeline --offline": ["pipeline", "--grid", g, "--frames", "0",
                               "--offline", str(offline_nf), "--ply",
                               f"{out_d}/offline.ply"],
        "masks": ["masks"],
        "carve": ["carve", "--grid", g, "--ply", f"{out_d}/hull.ply"],
        "carve --batched": ["carve", "--grid", g, "--batched", "--frames",
                            str(batched), "--ply", f"{out_d}/b"],
        "mesh": ["mesh", "--grid", g, "--obj", f"{out_d}/hull.obj"],
        "render": ["render", "--grid", g, "--png", f"{out_d}/render.png"],
    }
    launches, seconds, printed = {}, {}, {}
    chunks = -(-bg_frames // TRAIN_CHUNK)
    n_cpu = min(cpu_frames, video_frames)
    steps = {}  # each command's record_steps
    for name, argv in commands.items():
        print(f"  {name} on {dev.type}:", flush=True)
        extra = [] if dev.type == "cuda" else ["--cpu"]
        for k in kernels:
            k.launches = 0
        with watch_training(torch, dev) as trained, \
                record_steps(n_cpu) as steps[name]:
            printed[name], seconds[name] = run_cli(cli, argv + common + extra)
        sync(torch, dev)
        launches[name] = {k.source.stem: k.launches for k in kernels}
        if name != "pipeline":
            continue
        # the training from video and the stream loop of ``pipeline``
        (train_s, model), = trained.calls
        k3_train = launches[name]["mog_train"]
        expect(dev.type == "cpu" or k3_train == 4 * chunks,
               f"pipeline's from_data_dir: 4 x {bg_frames} background frames "
               f"decoded and trained in {train_s:.2f} s, K3 launched "
               f"{launches[name]['mog_train']} times; {card}")
        entered = steps[name].entered
        period = np.diff(entered)[min(3, len(entered) - 2):] * 1e3
        stream = {"frames": len(entered),
                  "period_mean_ms": float(period.mean()),
                  "period_median_ms": float(np.median(period)),
                  "period_p90_ms": float(np.percentile(period, 90)),
                  "period_max_ms": float(period.max())}
        print(f"  the stream loop's period in `pipeline` (PrefetchingSource +"
              f" process_frame_fast + download) over its {len(period)} "
              f"frames from the 4th: mean {stream['period_mean_ms']:.3f}, "
              f"median {stream['period_median_ms']:.3f}, p90 "
              f"{stream['period_p90_ms']:.3f}, max "
              f"{stream['period_max_ms']:.3f} ms; {card}")
        # the same step on frames decoded beforehand (no decoding threads),
        # and the offline path on 2 chunks and on all the held frames
        alone = []
        for fr in held:
            t0 = time.perf_counter()
            occ, _ = model.process_frame_fast(fr)
            occ[:1].cpu()
            alone.append((time.perf_counter() - t0) * 1e3)
        stream["step_alone_ms"] = float(np.mean(alone[min(3, len(alone)
                                                          - 1):]))
        held = np.stack(held)
        offline_ms = {}
        for n in sorted({min(2 * offline_nf, len(held)), len(held)}):
            t0 = time.perf_counter()
            model.process_frames_offline(held[:n],
                                         frames_per_launch=offline_nf)
            offline_ms[n] = (time.perf_counter() - t0) * 1e3 / n
        stream["offline_ms_by_frames"] = offline_ms
        del held
        print(f"  the same step on {len(alone)} frames decoded beforehand: "
              f"{stream['step_alone_ms']:.3f} ms/frame; process_frames_offline"
              f" by frames: {offline_ms} ms/frame; {card}")
    total = {k.source.stem: sum(v[k.source.stem] for v in launches.values())
             for k in kernels}
    n_off = -(-video_frames // offline_nf)
    want_min = {
        "pipeline": {"carve_blocked": video_frames,
                     "ccl_combined": video_frames, "mog_train": 4 * chunks},
        "pipeline --offline": {"carve_frames": n_off, "ccl_combined": n_off,
                               "mog_train": 4 * chunks},
        "masks": {"mog_train": 4 * chunks},
        "carve --batched": {"carve_frames": 1},
    }
    short = [(c, k, launches[c][k], n) for c, want in want_min.items()
             for k, n in want.items() if launches[c][k] < n]
    expect(dev.type == "cpu" or not short,
           f"launches per command {launches} (short of the least expected: "
           f"{short})")
    stream_line = printed["pipeline"][-1]
    expect(stream_line.startswith(f"{video_frames} frames: "),
           f"pipeline streamed every frame: {stream_line!r}")
    off_line = next(ln for ln in printed["pipeline --offline"]
                    if "offline" in ln)
    cli_stream_ms = float(re.search(r": ([0-9.]+) ms/frame",
                                    stream_line).group(1))
    cli_offline_ms = float(re.search(r": ([0-9.]+) ms/frame",
                                     off_line).group(1))
    print(f"  pipeline {cli_stream_ms:.0f} ms/frame as it prints it (stream, "
          f"{video_frames} frames), offline {cli_offline_ms:.1f} ms/frame "
          f"({offline_nf}/launch); {card}")

    # every frame's occupancy: the stream (K2, K1) against the offline run
    # (K2, K4) of the same CLI on the same video
    stream_occ = steps["pipeline"].stream
    (off_occ, off_colors), = steps["pipeline --offline"].offline
    differ = [f for f, (occ, _) in enumerate(stream_occ)
              if not torch.equal(occ.cpu(), torch.from_numpy(off_occ[f]))]
    expect(len(stream_occ) == video_frames == len(off_occ) and not differ,
           f"the stream's occupancy equals `--offline {offline_nf}`'s on "
           f"every one of the {video_frames} frames ({len(stream_occ)} "
           f"stream and {len(off_occ)} offline frames; differ: "
           f"{differ[:8]})")
    n_occ = [int(occ.sum()) for occ, _ in stream_occ]
    expect(min(n_occ) > 0 and len(set(n_occ)) > 1,
           f"every frame occupies voxels ({min(n_occ)}-{max(n_occ)}), and "
           "not the same count on every frame")

    # the models: the cache ``masks`` trained equals ``pipeline``'s
    cache = f"{out_d}/bg_cache"
    st1 = artifacts.load_mog_state(f"{cache}/mog_cam1.npz", device="cpu")
    m1 = model.bg_states[0]
    expect(all(torch.equal(getattr(st1, n), getattr(m1, n).cpu())
               for n in ("weight", "mean", "var")),
           "masks' cache of camera 1 equals the model pipeline trained")
    del model

    # -- the same commands on the CPU (nothing to compare on the CPU) -------
    cpu_seconds, cpu_s = {}, 0.0
    if dev.type == "cpu":
        print("  the CPU side is skipped: the commands above ran on the CPU")
    else:
        shutil.copytree(cache, f"{out_c}/bg_cache")
        band = slice(H // 2, H // 2 + 8)
        p1 = MOGParams(history=bg_frames)
        t0 = time.perf_counter()
        band_cpu = gmm.train_mog(vio.read_video(
            f"{data}/cam1/background.avi")[:, band], p1, device="cpu")
        expect(all(torch.equal(getattr(st1, n)[band], getattr(band_cpu, n))
                   for n in ("weight", "mean", "var"))
               and int(st1.nframes) == bg_frames,
               f"camera 1's model from video, rows {band.start}-"
               f"{band.stop - 1}, bit-equal to the plain version on the CPU "
               f"({time.perf_counter() - t0:.1f} s)")
        n_bat = min(batched, 2)  # a batched carve needs 2 frames
        nf_cpu = min(offline_nf, n_cpu)  # one chunk, no padding frames
        cpu_commands = {
            "pipeline": ["pipeline", "--grid", g, "--frames", str(n_cpu),
                         "--ply", f"{out_c}/stream.ply"],
            "pipeline --offline": ["pipeline", "--grid", g, "--frames",
                                   str(n_cpu), "--offline", str(nf_cpu),
                                   "--ply", f"{out_c}/offline.ply"],
            "masks": ["masks"],
            "carve": ["carve", "--grid", g, "--ply", f"{out_c}/hull.ply"],
            "carve --batched": ["carve", "--grid", g, "--batched",
                                "--frames", str(n_bat), "--ply",
                                f"{out_c}/b"],
            "mesh": ["mesh", "--grid", g, "--obj", f"{out_c}/hull.obj"],
            "render": ["render", "--grid", g, "--png",
                       f"{out_c}/render.png"],
        }
        t_cpu = time.perf_counter()
        cpu_steps = record_steps(n_cpu)
        with models_from(cache), cpu_steps:
            for name, argv in cpu_commands.items():
                print(f"  {name} on the CPU:", flush=True)
                _, cpu_seconds[name] = run_cli(
                    cli, argv + ["--cpu", "--data", data, "--out-dir", out_c])
        cpu_s = time.perf_counter() - t_cpu
        files = (["stream.ply", "offline.ply", "hull.ply", "hull.obj",
                  "render.png"] + [f"mask_cam{c}.png" for c in range(1, 5)]
                 + [f"b.{i}.ply" for i in range(n_bat)])
        bad = same_files(out_d, out_c, files)
        expect(not bad, f"the card's output files equal the CPU's byte for "
               f"byte: {files} (differ: {bad}); CPU side {cpu_s:.1f} s")
        (cpu_occ, cpu_colors), = cpu_steps.offline
        same_stream = len(cpu_steps.stream) == n_cpu and all(
            torch.equal(a.cpu(), b) and torch.equal(ca.cpu(), cb)
            for (a, ca), (b, cb) in zip(stream_occ, cpu_steps.stream))
        same_offline = np.array_equal(off_occ[:n_cpu], cpu_occ) \
            and same_colors(off_colors, cpu_colors)
        expect(same_stream and same_offline,
               f"the card's first {n_cpu} frames of `pipeline` (occupancy "
               f"and colours) and of `--offline` (occupancy and each "
               f"frame's colours) equal the CPU's (stream {same_stream}, "
               f"offline {same_offline})")
    for name in ("stream.ply", "hull.ply"):
        with open(f"{out_d}/{name}") as f:
            head = f.read(200)
        n_vox = int(re.search(r"element vertex (\d+)", head).group(1))
        expect(n_vox > 0, f"{name}: {n_vox} voxels")

    # -- calibrate --mode extrinsics on phase 20's scene ---------------------
    t0 = time.perf_counter()
    sc = extrinsics_scene(torch, dev, ext_hw, ext_cams, bg_frames=ext_bg_frames)
    ext = write_extrinsics_rig(build_root, sc, ext_hw)
    ext_out = os.path.abspath(f"{build_root}/cli_ext_out")
    shutil.rmtree(ext_out, ignore_errors=True)
    cams_arg = ",".join(str(c) for c in range(1, ext_cams + 1))
    lines, ext_s = run_cli(cli, ["calibrate", "--mode", "extrinsics",
                                 "--cams", cams_arg, "--data", ext,
                                 "--out-dir", ext_out]
                           + ([] if dev.type == "cuda" else ["--cpu"]))
    from vbr_tpu_torch.utils import xmlio
    from vbr_tpu_torch.utils.config import CameraParams

    got = [CameraParams.from_arrays(*xmlio.load_camera_config(
        f"{ext_out}/cam{c}")) for c in range(1, ext_cams + 1)]
    errs, flipped = pose_errors(got, sc.cams)
    expect(all(r < EXT_BOUND_RAD and t < EXT_BOUND_MM for r, t in errs)
           and all(os.path.exists(f"{ext_out}/cam{c}/"
                                  "checkerboard_imagepoints.jpg")
                   for c in range(1, ext_cams + 1)),
           f"calibrate --mode extrinsics on MJPEG video: every pose within "
           f"{EXT_BOUND_RAD} rad and {EXT_BOUND_MM} mm "
           f"({[(round(r, 5), round(t, 2)) for r, t in errs]}, global frame "
           f"flipped: {flipped}) in {ext_s:.1f} s (scene "
           f"{time.perf_counter() - t0 - ext_s:.1f} s)")

    # -- calibrate (intrinsics) with --discard: the plot of its runs ------
    intrinsics = cli_calibrate_intrinsics(torch, dev, build_root, calib_views)

    seconds_phase = time.perf_counter() - t_phase
    return {"card": card, "frames": video_frames,
            "background_frames": bg_frames, "grid": grid_edge,
            "write_s": write_s, "decode_ms_per_frame": decode_ms,
            "prefetch_ms_per_frame": prefetch_ms, "train_s": train_s,
            "k3_launches_training": k3_train, "stream": stream,
            "cli_stream_ms": cli_stream_ms,
            "cli_offline_ms": cli_offline_ms, "launches": launches,
            "launches_cli": total, "seconds": seconds,
            "cpu_seconds": cpu_seconds, "cpu_side_s": cpu_s,
            "extrinsics": {"pose_errors": errs, "seconds": ext_s},
            "intrinsics": intrinsics,
            "seconds_phase": seconds_phase}


def hold_plot_pair(equal, digits_agree, rtol, what):
    """Two plots of calibrations made on the card and on the CPU: byte-equal
    where their printed digits agree; where a digit flipped, a drawn
    coordinate may round to another pixel, so phase 19's bound on the
    calibrations (``rtol`` ≤ 1e-6) holds instead."""
    if digits_agree:
        expect(equal, f"{what}: byte-equal card vs CPU (their printed "
               "digits agree)")
    else:
        expect(rtol <= 1e-6, f"{what}: the card's and the CPU's printed "
               "digits differ, so the plots are not held byte for byte; "
               f"phase 19's bound holds instead: rtol {rtol:.1e} <= 1e-6")


def cli_calibrate_intrinsics(torch, dev, build_root, views):
    """Phase 23's ``calibrate`` of intrinsics with ``--discard`` on
    ``write_board_video``'s ``views`` + 1 boards, on ``dev`` and (for a
    card) with ``--cpu``: the plot written by both, byte-equal where the
    printed digits agree.  Returns its report."""
    from vbr_tpu_torch.apps import cli

    t0 = time.perf_counter()
    intr = write_board_video(torch, dev, build_root, views)
    intr_lines, intr_png = {}, {}
    for side in ("card", "cpu") if dev.type == "cuda" else ("cpu",):
        out = os.path.abspath(f"{build_root}/cli_intr_out_{side}")
        shutil.rmtree(out, ignore_errors=True)
        lines, _ = run_cli(cli, ["calibrate", "--cams", "1", "--data", intr,
                                 "--out-dir", out, "--frame-interval", "1",
                                 "--discard", "--no-annotate"]
                           + ([] if side == "card" else ["--cpu"]))
        intr_lines[side] = [ln for ln in lines if "rms" in ln]
        png = f"{out}/intrinsic_params_cam1.png"
        expect(os.path.exists(png) and read_png(png).shape == (500, 1800, 3)
               and not any("skipped" in ln for ln in lines),
               f"calibrate ({side}) writes {os.path.basename(png)}, 1800x500")
        with open(png, "rb") as f:
            intr_png[side] = f.read()
        expect(any("discarded" in ln for ln in lines),
               f"calibrate --discard ({side}) drops the view rendered with "
               f"fy x {CLI_BAD_FY}: {intr_lines[side]}")
    intr_equal = None
    if dev.type == "cuda":
        from vbr_tpu_torch.utils import xmlio

        intr_equal = intr_png["card"] == intr_png["cpu"]
        Ks = [xmlio.load_camera_config(
            os.path.abspath(f"{build_root}/cli_intr_out_{s}/cam1"))[0]
            for s in ("card", "cpu")]
        hold_plot_pair(intr_equal, intr_lines["card"] == intr_lines["cpu"],
                       rel_err(Ks[0], Ks[1]), "calibrate's intrinsics plot "
                       f"({intr_lines['card']})")
    intr_s = time.perf_counter() - t0
    print(f"  calibrate (intrinsics, {views} + 1 views, --discard): "
          f"{intr_lines['cpu']}; plot byte-equal card vs --cpu: "
          f"{intr_equal}; {intr_s:.1f} s")
    return {"lines": intr_lines, "plot_equal": intr_equal, "seconds": intr_s}


def write_board_video(torch, dev, root, views):
    """A directory for ``calibrate`` of intrinsics: ``checkerboard.xml`` and
    ``cam1/checkerboard.avi`` (MJPEG, the rig's size) of ``views`` boards
    rendered on ``dev`` at cam1's poses of ``CALIB_NPZ`` (every
    ``CLI_CALIB_SS``² samples per pixel), then one more with fy stretched
    by ``CLI_BAD_FY``, which ``--discard`` drops."""
    from vbr_tpu_torch.native import VideoSink
    from vbr_tpu_torch.utils import xmlio

    H, W = RIG_HW
    data = f"{root}/cli_intr_rig_{views}"
    shutil.rmtree(data, ignore_errors=True)
    xmlio.save_storage(f"{data}/checkerboard.xml",
                       {"CheckerBoardWidth": CALIB_PATTERN[0],
                        "CheckerBoardHeight": CALIB_PATTERN[1],
                        "CheckerBoardSquareSize": CALIB_SQUARE})
    K, dist, rvecs, tvecs = calib_truth(1, RIG_HW, views + 1)
    bad = K.copy()
    bad[1, 1] *= CLI_BAD_FY
    frames = np.concatenate([
        render_boards(torch, dev, K, dist, rvecs[:-1], tvecs[:-1], RIG_HW,
                      ss=CLI_CALIB_SS),
        render_boards(torch, dev, bad, dist, rvecs[-1:], tvecs[-1:], RIG_HW,
                      ss=CLI_CALIB_SS)])
    with VideoSink(f"{data}/cam1/checkerboard.avi", CLI_FPS, W, H) as sink:
        for f in frames:
            sink.write(f)
    return data


def write_extrinsics_rig(root, sc, image_hw):
    """Phase 20's scene ``sc`` as a rig directory: each camera's
    intrinsics (``config.xml``), ``checkerboard.avi``, ``background.avi``
    and ``video.avi`` (the person frame), MJPEG."""
    from vbr_tpu_torch.native import VideoSink
    from vbr_tpu_torch.utils import xmlio

    H, W = image_hw
    data = f"{root}/cli_ext_rig_{H}x{W}"
    shutil.rmtree(data, ignore_errors=True)
    xmlio.save_storage(f"{data}/checkerboard.xml",
                       {"CheckerBoardWidth": CALIB_PATTERN[0],
                        "CheckerBoardHeight": CALIB_PATTERN[1],
                        "CheckerBoardSquareSize": CALIB_SQUARE})
    for c, cp in enumerate(sc.cams, start=1):
        xmlio.save_camera_config(f"{data}/cam{c}", cp.K, cp.dist,
                                 np.zeros(3), np.zeros(3))
        for name, frames in (("checkerboard.avi", sc.boards[c - 1]),
                             ("background.avi", sc.backs[c - 1]),
                             ("video.avi", sc.person[c - 1][None])):
            with VideoSink(f"{data}/cam{c}/{name}", CLI_FPS, W, H) as s:
                for f in frames:
                    s.write(f)
    return data


SESSION_VIEWS = 3  # phase 19's board views clicked through a session:
# those where the lens moves the inner corners least from the clicked
# quad's homography (corner_subpix's 5-pixel window starts near them)
SESSION_JITTER = (1.0, 2.0)  # px: the seeded offset of each click
SESSION_TOL_PX = 1e-3  # the corner phases' card-vs-CPU bound
REPORT_MODELS = ("KNN", "MOG", "MOG2")  # the reference's comparison grid


def outer_corners(K, dist, rvec, tvec):
    """(4, 2) f64 projections of the board's outer corners: one square
    beyond the inner lattice on every side (``render_boards``' board)."""
    from vbr_tpu_torch.ops import camera as cam_ops

    cols, rows = CALIB_PATTERN
    s = CALIB_SQUARE
    obj = np.array([[-s, -s, 0], [cols * s, -s, 0], [cols * s, rows * s, 0],
                    [-s, rows * s, 0]], np.float64)
    return cam_ops.project_points(obj, rvec, tvec, K, dist)


def click_session(session_cls, gray, clicks, device):
    """A ``ManualCornerSession`` on ``device`` fed ``clicks`` (4 points):
    all four, one undone, the last clicked again → its lattice."""
    s = session_cls(gray, CALIB_PATTERN, device=device)
    for x, y in clicks:
        s.click(x, y)
    expect(s.done, "four clicks interpolate the lattice")
    s.undo()
    expect(not s.done and len(s.clicks) == 3, "undo drops the lattice and "
           "the last click")
    s.click(*clicks[-1])
    expect(s.done, "the fourth click again gives the lattice back")
    return s.result


def intrinsic_runs(calib, pts_all, pts_kept, image_wh, device):
    """``calibrate``'s runs: all views, then after discard."""
    runs = []
    for label, pts in (("all views", pts_all), ("after discard", pts_kept)):
        if label == "after discard" and len(pts) == len(pts_all):
            break  # nothing discarded
        res = calib.calibrate_camera(pts, image_wh, CALIB_PATTERN,
                                     CALIB_SQUARE, device=device)
        runs.append(dict(label=label, rms=res.rms,
                         per_view_errors=res.per_view_errors, K=res.K,
                         intrinsic_std=res.intrinsic_std))
    return runs


def printed_digits(runs):
    """What ``calibrate`` prints of each run: rms to 3 decimals, K to 2."""
    return [(f"{r['rms']:.3f}", *(f"{r['K'][i, j]:.2f}" for i, j in
                                  ((0, 0), (1, 1), (0, 2), (1, 2))))
            for r in runs]


def reports_phase(torch, dev, board, discard, masks, tris,
                  build_root="build"):
    """Phase 24: the manual corner session and the reports (see ``run``).
    ``board``: cam1's (K, dist, rvecs, tvecs, frames) of phase 19;
    ``discard``: (points of its first views, those
    ``discard_bad_image_points`` kept, (w, h)); ``masks``: {model: (C, H, W)}
    of phase 20; ``tris``: phase 16's rig mesh.  Returns its report."""
    from vbr_tpu_torch.apps.manual_corners import ManualCornerSession
    from vbr_tpu_torch.ops import color
    from vbr_tpu_torch.pipelines import calibration as calib
    from vbr_tpu_torch.pipelines import reports

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    out_dir = os.path.join(build_root, "reports")
    shutil.rmtree(out_dir, ignore_errors=True)
    rep = {}

    # -- the manual corner session ----------------------------------------
    from vbr_tpu_torch.ops import corners

    K, dist, rvecs, tvecs, frames = board
    rng = np.random.default_rng(SEED + 24)
    truth = true_corners(K, dist, rvecs, tvecs)
    lens_px = np.array([np.linalg.norm(
        corners.interpolate_image_points_from_corners(
            outer_corners(K, dist, rv, tv), CALIB_PATTERN)[:, None]
        - t[None], axis=-1).min(1).max()
        for rv, tv, t in zip(rvecs, tvecs, truth)])
    views = np.sort(np.argsort(lens_px, kind="stable")[:SESSION_VIEWS])
    worst_dev, n_all = 0.0, 0
    to_truth, ms = [], {"card": [], "cpu": []}
    for i in views:
        gray = color.bgr_to_gray_u8(torch.from_numpy(frames[i])).numpy()
        quad = outer_corners(K, dist, rvecs[i], tvecs[i])
        off = rng.uniform(*SESSION_JITTER, quad.shape) * rng.choice(
            [-1.0, 1.0], quad.shape)
        clicks = [tuple(p) for p in quad + off]
        got = {}
        for side, d in (("card", dev), ("cpu", cpu)):
            got[side], s = timed_s(lambda: click_session(
                ManualCornerSession, gray, clicks, d), torch, d)
            ms[side].append(s * 1e3)
        expect(all(isinstance(g, np.ndarray) and g.shape == truth[i].shape
                   for g in got.values()),
               f"view {i}: the session's result is an {truth[i].shape} "
               "numpy lattice on both devices")
        worst_dev = max(worst_dev,
                        float(np.abs(got["card"] - got["cpu"]).max()))
        n_all += len(got["card"])
        # the lattice starts at the clicked quad's top-left corner, the
        # truth at the board's first inner corner: compare as point sets
        to_truth.append(np.linalg.norm(got["card"][:, None] - truth[i][None],
                                       axis=-1).min(1))
    expect(worst_dev <= SESSION_TOL_PX,
           f"the manual corner session on {len(views)} views (clicks "
           f"{SESSION_JITTER} px off the true outer corners, one undone): "
           f"all {n_all} refined corners, {dev.type} and the CPU within "
           f"{worst_dev:.1e} px (<= {SESSION_TOL_PX})")
    to_truth = np.concatenate(to_truth)
    rep["session"] = {"views": views.tolist(), "max_diff_px": worst_dev,
                      "corners": n_all,
                      "lens_px": float(lens_px[views].max()),
                      "err_vs_truth_px": {"median": float(np.median(to_truth)),
                                          "max": float(to_truth.max())},
                      "ms_per_session": {k: float(np.median(v))
                                         for k, v in ms.items()}}
    # the homography ignores the lens: where the distortion moves a corner
    # further than corner_subpix's 5-pixel window reaches, it stays off
    print(f"  session on views {views.tolist()} (the homography's lattice "
          f"at most {lens_px[views].max():.2f} px from the inner corners): "
          f"refined lattice vs the true inner corners, median "
          f"{np.median(to_truth):.3f} px, worst {to_truth.max():.3f} px; "
          f"ms per session {dev.type} "
          f"{rep['session']['ms_per_session']['card']:.1f}, CPU "
          f"{rep['session']['ms_per_session']['cpu']:.1f}")

    # -- the mask grid ------------------------------------------------------
    path = os.path.join(out_dir, "background_models_mask_comparisons.png")
    _, s = timed_s(lambda: reports.plot_mask_comparison(masks, path),
                   torch, cpu)
    C = len(next(iter(masks.values())))
    img = read_png(path)
    expect(img.shape == (500 * C, 600 * len(masks), 3),
           f"{os.path.basename(path)} reads back at {img.shape[1]}x"
           f"{img.shape[0]} ({len(masks)} models x {C} cameras)")
    rep["mask_grid_ms"] = s * 1e3

    # -- the intrinsics plot, card and CPU --------------------------------
    pts_all, pts_kept, wh = discard
    runs = {side: intrinsic_runs(calib, pts_all, pts_kept, wh, d)
            for side, d in (("card", dev), ("cpu", cpu))}
    paths = {}
    for side, r in runs.items():
        paths[side] = os.path.join(out_dir, f"intrinsic_params_{side}.png")
        _, s = timed_s(lambda: reports.plot_intrinsic_results(
            r, paths[side]), torch, cpu)
        rep.setdefault("intrinsics_ms", {})[side] = s * 1e3
        expect(read_png(paths[side]).shape == (500, 1800, 3),
               f"{os.path.basename(paths[side])} reads back at 1800x500")
    same = printed_digits(runs["card"]) == printed_digits(runs["cpu"])
    with open(paths["card"], "rb") as fa, open(paths["cpu"], "rb") as fb:
        equal = fa.read() == fb.read()
    hold_plot_pair(equal, same, max(
        max(rel_err(a["K"], b["K"]), rel_err(a["rms"], b["rms"]),
            rel_err(a["per_view_errors"], b["per_view_errors"]))
        for a, b in zip(runs["card"], runs["cpu"])),
        f"the intrinsics plot of {[r['label'] for r in runs['card']]}")
    rep["intrinsics"] = {"runs": [r["label"] for r in runs["card"]],
                         "byte_equal": equal, "digits_agree": same}

    # -- the mesh snapshot --------------------------------------------------
    imgs, ms = {}, {}
    for side, d in (("card", dev), ("cpu", cpu)):
        t_d = torch.from_numpy(np.ascontiguousarray(tris)).to(d)
        imgs[side] = reports.render_mesh_snapshot(t_d, device=d)
        reps = []
        for _ in range(3):
            _, s = timed_s(lambda: reports.render_mesh_snapshot(
                t_d, device=d), torch, d)
            reps.append(s * 1e3)
        ms[side] = float(np.median(reps))
    expect(torch.equal(imgs["card"].cpu(), imgs["cpu"]),
           f"the mesh snapshot of {len(tris)} triangles on {dev.type} "
           "bit-equal to the CPU's (1000x1000)")
    path = os.path.join(out_dir, "marching_cubes.png")
    _, s = timed_s(lambda: reports.plot_mesh_snapshot(tris, path, device=dev),
                   torch, dev)
    back = read_png(path)
    expect(back.shape == (1000, 1000, 3)
           and np.array_equal(back, imgs["cpu"].numpy()),
           f"{os.path.basename(path)} reads back at 1000x1000, equal to the "
           "rendered image")
    back_i = back.astype(np.int32)
    blue = int((back_i[..., 2] > back_i[..., 0] + 60).sum())
    rep["mesh"] = {"triangles": len(tris), "render_ms": ms,
                   "plot_ms": s * 1e3, "covered_px": blue}
    print(f"  figures ms: mask grid {rep['mask_grid_ms']:.1f}, intrinsics "
          f"{rep['intrinsics_ms']['card']:.1f} (runs "
          f"{rep['intrinsics']['runs']}, byte-equal {equal}), mesh plot "
          f"{s * 1e3:.1f}; the rasteriser on {len(tris)} triangles "
          f"{ms['card']:.1f} ms ({dev.type}), {ms['cpu']:.1f} ms (CPU), "
          f"{blue} px covered")
    rep["seconds"] = time.perf_counter() - t_phase
    return rep


def run(device, image_hw=(486, 644), grid=None, focal=490.0,
        mask_params=None, train_frames=TRAIN_FRAMES, k3_frames=TRAIN_CHUNK,
        label_large_hw=(1088, 1920), label_cap=LABEL_CAP,
        seam_sizes=((128, 64, 128), (100, 50, 100)), roi_hw=ROI_HW,
        large_edges=LARGE_EDGES, calib_hw=CALIB_HW, calib_views=None,
        calib_iters=CALIB_ITERS, ext_hw=RIG_HW, ext_cams=4,
        ext_iters=EXT_ITERS, ext_bg_frames=EXT_BG_FRAMES, ext_grid=EXT_GRID,
        viewer_grid=VIEWER_GRID, viewer_hw=VIEWER_HW,
        viewer_points=VIEWER_POINTS, cli_frames=(CLI_BG_FRAMES,
                                                 CLI_VIDEO_FRAMES),
        cli_grid=CLI_GRID, cli_nf=(CLI_OFFLINE_NF, CLI_BATCHED,
                                   CLI_CPU_FRAMES)):
    """All phases on ``device`` for a rig of ``image_hw`` images, a
    ``grid`` (default: the production 128³) and cameras of focal length
    ``focal``, comparing K3 on a chunk of ``k3_frames`` frames and training
    on ``train_frames`` background frames per camera, holding the
    labelling kernels at the cap ``label_cap`` and on a ``label_large_hw``
    image besides, driving the viewer seam at the two
    ``set_voxel_positions`` sizes ``seam_sizes`` (the second not divisible
    by 8·sup), the large grids at the edges ``large_edges`` (the rig's
    steps, the 8-camera carve) and the calibration on boards rendered at
    ``calib_hw``, ``calib_views`` poses per camera (None: all) and
    ``calib_iters`` Adam steps, and the extrinsics on ``ext_cams`` of the
    rig's cameras at ``ext_hw`` with ``ext_iters`` photometric steps,
    ``ext_bg_frames`` background frames and a carve A/B grid of
    ``ext_grid``³, and the viewer's headless render of the rig at
    ``viewer_grid``³ and of ``viewer_points`` lattice points at
    ``viewer_hw``, and the CLI on a rig directory of ``cli_frames``
    (background, video) frames per camera at ``cli_grid``³, with
    ``cli_nf`` (``--offline`` frames per launch, ``carve --batched``
    frames, frames of the CPU side), its calibration on the extrinsics'
    scene, and the manual corner session and the
    reports on what phases 16, 19 and 20 hand over; returns the
    per-kernel report."""
    import torch

    from vbr_tpu_torch.models.visual_hull import VisualHull, _full_step
    from vbr_tpu_torch.ops import carve_blocked as cb
    from vbr_tpu_torch.ops import ccl_label, gmm
    from vbr_tpu_torch.ops._cuda import build_kernels
    from vbr_tpu_torch.ops.color import bgr_to_hsv_u8
    from vbr_tpu_torch.pipelines import background
    from vbr_tpu_torch.utils.config import (
        DEFAULT_MASK_PARAMS, GridConfig, MOGParams, RigConfig)

    dev = torch.device(device)
    grid = grid or GridConfig()
    H, W = image_hw
    kernels = (cb.K1, ccl_label.K2, gmm.K3, cb.K4, ccl_label.K5)

    print("[2] build", flush=True)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        build_kernels(kernels)
        print(f"  kernels built in {time.perf_counter() - t0:.2f} s "
              "(one nvcc per source, in parallel)")
        for k in kernels:
            usage = [ln.strip() for ln in k.build_log.splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  {k.source.name}: {' | '.join(usage) or 'cached'}")

    # -- rig, model, frames ---------------------------------------------
    r = seeded_rig(torch, image_hw, focal)
    rng, cams, bg, states = r.rng, r.cams, r.bg, r.states
    center0, frame0, seq = r.center0, r.frame0, r.seq
    rig = RigConfig(image_height=H, image_width=W)

    def model_on(d):
        return seeded_model(r, d, grid, mask_params)

    t0 = time.perf_counter()
    model = model_on(dev)
    print(f"  model set-up (f64 tables, MOG compression): "
          f"{time.perf_counter() - t0:.2f} s; Ke = "
          f"{model._stacked_fz.thr.shape[-1]}")
    frame0_d = torch.from_numpy(frame0).to(dev)
    btab = model._btab
    # L2 flush before each timed launch: READ a buffer larger than the 50 MB
    # L2 (a reduction into one element), which leaves no dirty lines behind
    # for the timed kernel's first misses to write back, as zeroing it would
    flush_buf = (torch.empty(8 << 20, dtype=torch.int64, device=dev)
                 if dev.type == "cuda" else None)
    flush = flush_buf.sum if dev.type == "cuda" else None
    launch_floor_ms = None
    if dev.type == "cuda":
        empty = cb.K1.function("vbr_empty_launch", [ctypes.c_void_p])

        def empty_launch():
            cb.K1.status_ok(empty(ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream)), "empty launch")

        launch_floor_ms = timed_ms(empty_launch, torch, dev, flush=flush)
        print(f"  launch_floor_ms {launch_floor_ms:.5f} (a kernel that "
              "returns at once, between the same two events)")

    # stage inputs of the two kernels on the main-path frame
    raw = background.raw_masks_batched_fz(model._stacked_fz, frame0_d,
                                          model.mask_params)
    masks = model.masks(frame0_d)
    Hp, Wp = -(-H // 8) * 8, -(-W // 128) * 128
    phase = torch.zeros((len(cams), Hp, Wp), dtype=torch.bool, device=dev)
    phase[:, :H, :W] = raw > 0  # as ``clean_masks_batched`` hands it over

    # -- [3] K1 ----------------------------------------------------------
    print("[3] K1 carve vs its plain version", flush=True)
    vt = rig.views_threshold
    active, full = cb.block_activity(masks, vt, btab.allv, btab.ry, btab.rx)
    k1_args = (btab.pk, btab.lcc, active, full, masks,
               frame0_d[btab.color_camera].contiguous())
    k1_kw = dict(color_camera=btab.color_camera, views_threshold=vt)
    got = cb.carve_blocked_kernel(*k1_args, **k1_kw)
    want = cb.carve_blocked_plain(*k1_args, **k1_kw)
    sync(torch, dev)
    k1_err = max_abs_err(zip(got, want))
    expect(k1_err == 0 and all(torch.equal(a, b) for a, b in zip(got, want)),
           "K1 occupancy and colours bit-equal to the plain version")
    k1_ms = timed_ms(lambda: cb.carve_blocked_kernel(*k1_args, **k1_kw),
                     torch, dev, flush=flush)
    k1_plain_ms = timed_ms(lambda: cb.carve_blocked_plain(*k1_args, **k1_kw),
                           torch, dev, flush=flush)
    k1_ms_zeroing_flush = (timed_ms(
        lambda: cb.carve_blocked_kernel(*k1_args, **k1_kw), torch, dev,
        flush=flush_buf.zero_) if dev.type == "cuda" else None)
    nblk, C = btab.nsuper * btab.nsub, btab.num_cameras
    k1 = k1_work(torch, cb, btab, active, full, masks, got[0])
    k1_bound, k1_bound_by = k1.bound, k1.bound_by
    print(f"  K1 {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, {k1.text}")
    if dev.type == "cuda":
        print(f"  K1 after a zeroing flush (dirty lines in L2): "
              f"{k1_ms_zeroing_flush:.4f} ms")
    k1_plan = cb.k1_launch_plan(nblk, C) if dev.type == "cuda" else None
    print(f"  K1 launch: {k1_plan}")
    k1_err = max(k1_err, hold_carve(torch, dev, cb, cams, image_hw, btab,
                                    masks, frame0_d, vt))

    # -- [4] K2 ----------------------------------------------------------
    print("[4] K2 combined-phase labelling vs its plain version", flush=True)
    labels, iters = ccl_label.label_components_combined(phase)
    labels_p, iters_p = ccl_label.label_components_combined_plain(phase)
    sync(torch, dev)
    k2_err = max_abs_err([(labels, labels_p), (iters, iters_p)])
    expect(k2_err == 0 and torch.equal(labels, labels_p)
           and torch.equal(iters, iters_p),
           f"K2 labels bit-equal at {tuple(phase.shape)}, iterations to "
           f"fixpoint {iters.tolist()}")
    k2_ms = timed_ms(lambda: ccl_label.label_components_combined(phase),
                     torch, dev, flush=flush)
    k2_plain_ms = timed_ms(
        lambda: ccl_label.label_components_combined_plain(phase), torch, dev,
        flush=flush)
    # the least this data needs: 1 byte in, 4 out per pixel, and the counts
    k2_bytes = phase.numel() * (1 + 4) + 4 * len(cams)
    k2_ops = K2_OPS_PER_PIXEL_ITER * Hp * Wp * int(iters.sum())
    k2_bound, k2_bound_by = bound(k2_bytes, k2_ops)
    k2_route = (ccl_label.kernel_route(ccl_label.K2, Hp, Wp)
                if dev.type == "cuda" else None)
    print(f"  K2 {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound "
          f"{k2_bound:.5f} ms ({k2_bound_by}: {k2_bytes} B, {k2_ops} ops); "
          f"route at {(Hp, Wp)}: {k2_route}")
    if dev.type == "cuda":
        k2_iter_us = per_iteration_us(
            torch, dev, ccl_label.label_components_combined, Hp, Wp)
        print(f"  K2 {k2_iter_us:.2f} us per iteration (one image, serpentine)")
    label_batch = OFFLINE_NF * len(cams)  # images per launch, offline path
    k2_err = max(k2_err, hold_labelling(
        torch, dev, "K2", ccl_label.K2, ccl_label.label_components_combined,
        ccl_label.label_components_combined_plain, label_large_hw,
        label_batch, label_cap, Hp, Wp))

    # -- [5] main path on the card and on the CPU -------------------------
    print("[5] main path: process_frame_fast, card vs CPU", flush=True)
    for k in kernels:
        k.launches = 0
    occ, col = model.process_frame_fast(frame0)
    sync(torch, dev)
    counts5 = [k.launches for k in kernels[:2]]
    expect(all(n >= 1 for n in counts5) or dev.type == "cpu",
           f"launch counters advanced on the main path: K1 {counts5[0]}, "
           f"K2 {counts5[1]}")
    t0 = time.perf_counter()
    model_cpu = model_on("cpu")
    occ_c, col_c = model_cpu.process_frame_fast(frame0)
    print(f"  CPU run (plain versions): {time.perf_counter() - t0:.1f} s")
    expect(occ.shape == (grid.num_voxels,) and col.shape == (grid.num_voxels, 3)
           and torch.equal(occ.cpu(), occ_c) and torch.equal(col.cpu(), col_c),
           f"occupancy and colours bit-equal card vs CPU "
           f"({int(occ_c.sum())} occupied voxels)")
    expect(0 < int(occ_c.sum()) < grid.num_voxels, "non-degenerate hull")

    def step():
        model.process_frame_fast(frame0)
        sync(torch, dev)

    step_ms = timed_ms(step, torch, dev, reps=10)
    print(f"  process_frame_fast {step_ms:.3f} ms/frame (median of 10)")

    # -- [6] stream ------------------------------------------------------
    print(f"[6] stream over {STREAM_FRAMES} frames", flush=True)
    list(model.stream(iter(seq[:2])))  # warm-up
    sync(torch, dev)
    for k in kernels:
        k.launches = 0
    stamps = [time.perf_counter()]
    outs = []
    for out in model.stream(iter(seq)):
        outs.append(out)
        stamps.append(time.perf_counter())
    sync(torch, dev)
    launches = [k.launches for k in kernels[:2]]
    per_frame = np.diff(stamps) * 1e3
    stream_ms = (stamps[-1] - stamps[0]) * 1e3 / STREAM_FRAMES
    expect(len(outs) == STREAM_FRAMES and all(n >= STREAM_FRAMES
                                              for n in launches)
           or dev.type == "cpu",
           f"stream yielded {len(outs)} frames; launches K1 {launches[0]}, "
           f"K2 {launches[1]}")
    ref0 = model.process_frame_fast(seq[0], layout="blocked")
    expect(all(torch.equal(a, b) for a, b in zip(outs[0], ref0)),
           "stream frame 0 equals process_frame_fast(layout='blocked')")
    print(f"  stream {stream_ms:.3f} ms/frame (mean); per frame "
          f"{np.round(per_frame, 3).tolist()}")

    # -- [7] overflow ----------------------------------------------------
    print("[7] overflow frame: exact host redo", flush=True)
    fo = paint_frame(rng, cams, bg, center0, speckle=0)
    fo[:, ::3, ::3] = subject_texture(H, W)[::3, ::3]  # components > kf
    _, _, ovf = _full_step(
        model._stage, torch.from_numpy(fo).to(dev), btab,
        views_threshold=vt, layout="canonical")
    expect(bool(ovf.any()), f"overflow bits set: {ovf.tolist()}")
    occ_o, col_o = model.process_frame_fast(fo)
    occ_oc, col_oc = model_cpu.process_frame_fast(fo)
    expect(torch.equal(occ_o.cpu(), occ_oc) and torch.equal(col_o.cpu(), col_oc),
           "overflowed frame redone exactly, card vs CPU")

    profile = profile_step(
        torch, step, step_ms,
        "[8] profile of 4 process_frame_fast steps") if dev.type == "cuda" \
        else None

    # -- [9] K3 ----------------------------------------------------------
    print(f"[9] K3 MOG training vs its plain version ({k3_frames} frames "
          "from a mid-training state)", flush=True)
    p_mid = MOGParams()
    # the chunk crosses the 1/history clamp of the learning rate
    ts0 = gmm.MOGTrainState(*(a if a is None else a.to(dev)
                              for a in train_state_from_mog(
        states[0], torch, p_mid.history - k3_frames // 2)))
    ts0 = ts0._replace(used=gmm.slot_high_water(ts0.weight, ts0.sort_key))
    chunk_bgr = background_sequence(rng, bg[0], k3_frames, sigma=6.0)
    chunk = bgr_to_hsv_u8(torch.from_numpy(chunk_bgr).to(dev)).contiguous()

    def clone_state():
        return clone_train_state(ts0)

    got3 = gmm.train_chunk_kernel(clone_state(), chunk, p_mid)
    want3 = gmm.train_chunk_plain(ts0, chunk, p_mid)
    sync(torch, dev)
    names3 = ("weight", "sort_key", "mean", "var")
    k3_err = max_abs_err((getattr(got3, n), getattr(want3, n))
                         for n in names3)
    used = got3.weight > 0
    expect(k3_err == 0 and all(torch.equal(getattr(got3, n),
                                           getattr(want3, n))
                               for n in names3 + ("nframes",)),
           "K3 weight, sort_key, mean and var bit-equal to the plain "
           f"version; slots in use per pixel: mean "
           f"{float(used.sum(dim=0).float().mean()):.2f}, max "
           f"{int(used.sum(dim=0).max())}; changed weights "
           f"{float((got3.weight != ts0.weight).float().mean()):.4f}")
    k3_ms = timed_ms(lambda st: gmm.train_chunk_kernel(st, chunk, p_mid),
                     torch, dev, reps=5, flush=flush, setup=clone_state)
    k3_plain_ms = timed_ms(lambda: gmm.train_chunk_plain(ts0, chunk, p_mid),
                           torch, dev, reps=2, flush=flush)
    # the update is in place and leaves a never-used slot (all zeros)
    # alone, so this data needs the used slots' 8 floats read and written
    # once, the frames read once, the mark and nframes read and written
    n_used = int(used.sum())
    k3_bytes = 2 * 32 * n_used + chunk.numel() + 2 * 4 * (H * W + 1)
    k3_ops = k3_frames * n_used * 25  # per used slot and frame
    k3_bound, k3_bound_by = bound(k3_bytes, k3_ops)
    print(f"  K3 {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms, bound "
          f"{k3_bound:.5f} ms ({k3_bound_by}: {k3_bytes} B, {k3_ops} ops)")
    expect(got3.used is None and dev.type == "cpu"
           or torch.equal(got3.used, gmm.slot_high_water(want3.weight,
                                                         want3.sort_key)),
           "K3 carried mark equals the one recomputed from the state")
    k3_plan, k3_by_slots = None, {}
    if dev.type == "cuda":
        k3_plan = gmm.k3_launch_plan(p_mid.n_mixtures, H * W)
        for slots in (4, 7, 8, 12, 16):
            k3_by_slots[slots] = timed_ms(
                lambda st: gmm._launch_k3(st, chunk, p_mid, slots), torch,
                dev, reps=5, flush=flush, setup=clone_state)
        k3_one_ms = timed_ms(
            lambda st: gmm.train_chunk_kernel(st, chunk[:1], p_mid), torch,
            dev, reps=5, flush=flush, setup=clone_state)
        k3_plan["ms_by_cache_slots"] = k3_by_slots
        k3_plan["ms_one_frame"] = k3_one_ms
        print(f"  K3 launch: {k3_plan}; a chunk of one frame {k3_one_ms:.4f} "
              f"ms, so {(k3_ms - k3_one_ms) * 1e3 / max(k3_frames - 1, 1):.2f}"
              " us per further frame")
    worst3, k3_deepest = hold_training(torch, dev, gmm, ts0, image_hw, p_mid)
    k3_err = max(k3_err, worst3)
    expect(k3_deepest > gmm.K3_CACHE_SLOTS,
           f"K3: random frames drive a pixel to {k3_deepest} slots, past "
           f"the {gmm.K3_CACHE_SLOTS} the kernel caches")
    if dev.type == "cuda":
        def k3_step():
            gmm.train_chunk_kernel(clone_state(), chunk, p_mid)
            sync(torch, dev)

        k3_step_ms = timed_ms(k3_step, torch, dev, reps=3)
        k3_profile = profile_step(
            torch, k3_step, k3_step_ms,
            "  profile of two K3 launches (each after a copy of the state):",
            frames=2, top=4)
    else:
        k3_profile = None
    del got3, want3, ts0, used

    # -- [10] training end to end ----------------------------------------
    print(f"[10] train_background on {train_frames} frames per camera",
          flush=True)
    t0 = time.perf_counter()
    bg_seqs = [background_sequence(rng, bg[c], train_frames)
               for c in range(len(cams))]
    print(f"  background sequences made in {time.perf_counter() - t0:.2f} s")
    model_tr = VisualHull(cams, grid, rig, mask_params or DEFAULT_MASK_PARAMS,
                          device=dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    model_tr.train_background(bg_seqs)
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    k3_launches = gmm.K3.launches
    want_launches = len(cams) * -(-train_frames // TRAIN_CHUNK)
    expect(k3_launches == want_launches or dev.type == "cpu",
           f"K3 launched {k3_launches} times ({len(cams)} cameras x "
           f"{-(-train_frames // TRAIN_CHUNK)} chunks); training took "
           f"{train_s:.2f} s")
    band = slice(H // 2, H // 2 + 8)
    p_tr = model_tr.mog_params[0]
    expect(p_tr.history == train_frames, "history = frames per camera")
    band_cpu = gmm.train_mog(bg_seqs[0][:, band], p_tr, device="cpu")
    st0 = model_tr.bg_states[0]
    expect(all(torch.equal(getattr(st0, n)[band].cpu(), getattr(band_cpu, n))
               for n in ("weight", "mean", "var"))
           and int(st0.nframes) == train_frames,
           f"trained model of camera 1, rows {band.start}-{band.stop - 1}, "
           "bit-equal to the plain version on the CPU")
    slots = (st0.weight > 0).sum(dim=-1)
    expect(int(slots.min()) >= 1 and int(slots.max()) >= 2,
           f"slots filled per pixel: min {int(slots.min())}, mean "
           f"{float(slots.float().mean()):.2f}, max {int(slots.max())}")

    # -- [11] K4 ---------------------------------------------------------
    print(f"[11] K4 multi-frame carve vs its plain version ({OFFLINE_NF} "
          "frames)", flush=True)
    masks8, active8, full8 = k4_chunk(torch, cb, model, seq)
    got4 = cb.carve_frames_kernel(btab.pk, active8, full8, masks8,
                                  views_threshold=vt)
    want4 = cb.carve_frames_plain(btab.pk, active8, full8, masks8,
                                  views_threshold=vt)
    sync(torch, dev)
    k4_err = max_abs_err([(got4, want4)])
    per_frame_occ = got4.flatten(1).sum(dim=1).tolist()
    expect(k4_err == 0 and torch.equal(got4, want4)
           and min(per_frame_occ) > 0,
           f"K4 occupancy bit-equal at {tuple(got4.shape)}; occupied "
           f"voxels per frame {per_frame_occ}")
    k4_ms = timed_ms(lambda: cb.carve_frames_kernel(
        btab.pk, active8, full8, masks8, views_threshold=vt), torch, dev,
        flush=flush)
    k4_plain_ms = timed_ms(lambda: cb.carve_frames_plain(
        btab.pk, active8, full8, masks8, views_threshold=vt), torch, dev,
        reps=5, flush=flush)
    k4 = k4_work(torch, cb, btab, active8, full8, masks8, got4)
    k4_bound, k4_bound_by = k4.bound, k4.bound_by
    print(f"  K4 {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, {k4.text}")
    k4_plan = (cb.k4_launch_plan(nblk, C, OFFLINE_NF) if dev.type == "cuda"
               else None)
    print(f"  K4 launch: {k4_plan}")
    k4_err = max(k4_err, hold_frames(torch, dev, cb, cams, image_hw, btab,
                                     masks8, vt))

    # -- [12] offline path -----------------------------------------------
    print(f"[12] process_frames_offline over {STREAM_FRAMES} frames on the "
          "trained model", flush=True)
    seq_np = np.stack(seq)
    model_tr.process_frames_offline(seq_np[:OFFLINE_NF],
                                    frames_per_launch=OFFLINE_NF)  # warm-up
    sync(torch, dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    occ_off, col_off = model_tr.process_frames_offline(
        seq_np, frames_per_launch=OFFLINE_NF)
    sync(torch, dev)
    offline_ms = (time.perf_counter() - t0) * 1e3 / STREAM_FRAMES
    off_launches = {k.source.stem: k.launches for k in kernels}
    k4_launches = cb.K4.launches
    expect(k4_launches >= STREAM_FRAMES // OFFLINE_NF or dev.type == "cpu",
           f"launches on the offline path: {off_launches}")
    expect(occ_off.shape == (STREAM_FRAMES, grid.num_voxels)
           and occ_off.dtype == bool, "offline occupancy (F, N) bool")
    for f in range(STREAM_FRAMES):
        occ_f, col_f = model_tr.process_frame_fast(seq[f])
        occ_f, col_f = occ_f.cpu().numpy(), col_f.cpu().numpy()
        idx, col = col_off[f]
        if not (np.array_equal(occ_off[f], occ_f)
                and np.array_equal(idx, np.flatnonzero(occ_f))
                and np.array_equal(col, col_f[idx])):
            raise Failed(f"offline frame {f} differs from process_frame_fast")
    n_occ_off = occ_off.sum(axis=1)
    expect(n_occ_off.min() > 0 and len(set(n_occ_off.tolist())) > 1,
           "per-frame occupancy and colours at occupied voxels equal to "
           f"process_frame_fast; occupied voxels {n_occ_off.tolist()}")
    print(f"  offline {offline_ms:.3f} ms/frame (host clock, upload and "
          f"colours included) beside stream {stream_ms:.3f} ms/frame")
    offline_profile = profile_step(
        torch, lambda: model_tr.process_frames_offline(
            seq_np, frames_per_launch=OFFLINE_NF),
        offline_ms, "  profile of one offline pass:", frames=STREAM_FRAMES,
        frames_per_step=STREAM_FRAMES) if dev.type == "cuda" else None

    # -- [13] K5 ---------------------------------------------------------
    print("[13] K5 single-phase labelling vs its plain version", flush=True)
    fg5 = phase
    ccl_label.K5.launches = 0
    labels5, iters5 = ccl_label.label_components_batched(fg5)
    sync(torch, dev)
    k5_launches = ccl_label.K5.launches
    labels5_p, iters5_p = ccl_label.label_components_batched_plain(fg5)
    k5_err = max_abs_err([(labels5, labels5_p), (iters5, iters5_p)])
    expect(k5_err == 0 and torch.equal(labels5, labels5_p)
           and torch.equal(iters5, iters5_p)
           and (k5_launches == 1 or dev.type == "cpu"),
           f"K5 labels bit-equal at {tuple(fg5.shape)}, iterations to "
           f"fixpoint {iters5.tolist()}")
    expect(bool((labels5[~fg5] == ccl_label.BIG).all())
           and bool((labels5[fg5] < Hp * Wp).all()),
           "background 2^30, foreground a linear index")
    k5_ms = timed_ms(lambda: ccl_label.label_components_batched(fg5), torch,
                     dev, flush=flush)
    k5_plain_ms = timed_ms(
        lambda: ccl_label.label_components_batched_plain(fg5), torch, dev,
        reps=5, flush=flush)
    k5_bytes = fg5.numel() * (1 + 4) + 4 * len(cams)  # as for K2
    k5_ops = K5_OPS_PER_PIXEL_ITER * Hp * Wp * int(iters5.sum())
    k5_bound, k5_bound_by = bound(k5_bytes, k5_ops)
    k5_route = (ccl_label.kernel_route(ccl_label.K5, Hp, Wp)
                if dev.type == "cuda" else None)
    print(f"  K5 {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, bound "
          f"{k5_bound:.5f} ms ({k5_bound_by}: {k5_bytes} B, {k5_ops} ops); "
          f"route at {(Hp, Wp)}: {k5_route}")
    if dev.type == "cuda":
        k5_iter_us = per_iteration_us(
            torch, dev, ccl_label.label_components_batched, Hp, Wp)
        print(f"  K5 {k5_iter_us:.2f} us per iteration (one image, serpentine)")
    k5_err = max(k5_err, hold_labelling(
        torch, dev, "K5", ccl_label.K5, ccl_label.label_components_batched,
        ccl_label.label_components_batched_plain, label_large_hw,
        label_batch, label_cap, Hp, Wp))
    if dev.type == "cuda":
        expect(k2_route["route"] == k5_route["route"] == "cluster",
               f"the production shape {(Hp, Wp)} takes the cluster route")
        # last of the kernel checks: it holds ~7 GB of the card
        print("[11] K4 on a chunk of more than 2^31 mask bytes", flush=True)
        k4_err = max(k4_err, hold_frames_limits(torch, dev, cb))

    # -- [14] the viewer seam on the rig ----------------------------------
    print(f"[14] the viewer seam on the rig: set_voxel_positions"
          f"{tuple(seam_sizes[0])} over {RIG_FRAMES} frames", flush=True)
    rig_models, seam = seam_phase(torch, dev, kernels, r, mask_params,
                                  image_hw, seam_sizes)

    # -- [15] K1 and K4 at any camera count -------------------------------
    print("[15] K1 and K4 at camera counts other than the rig's", flush=True)
    worst = hold_camera_counts(torch, dev, cb)
    k1_err, k4_err = max(k1_err, worst["K1"]), max(k4_err, worst["K4"])

    # -- [16] the surface path --------------------------------------------
    print(f"[16] the surface path: process_frame_surface{SURFACE_PAIR}, "
          f"capacity {SURFACE_CAPACITY}", flush=True)
    t0 = time.perf_counter()
    kept = {}  # what phases 16, 19 and 20 hand to phase 24
    surface = surface_phase(torch, dev, kernels, flush, model, model_cpu,
                            frame0, occ_c, col_c, seq, rig_models, step_ms,
                            keep=kept)
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s")

    # -- [17] the thin-link viewer stream ---------------------------------
    print(f"[17] the thin-link viewer stream: stream_viewer over the rig's "
          f"{RIG_FRAMES} frames, ingest {INGESTS}", flush=True)
    t0 = time.perf_counter()
    viewer = viewer_phase(torch, dev, kernels, flush, model, model_cpu, fo,
                          rig_models, roi_hw)
    print(f"  phase 17 in {time.perf_counter() - t0:.1f} s")

    # -- [18] large grids --------------------------------------------------
    print(f"[18] large grids: the device table builds, the rig at "
          f"{large_edges[0]}^3, {STRETCH_CAMERAS} cameras at "
          f"{large_edges[1]}^3, the fused carve", flush=True)
    t0 = time.perf_counter()
    stretch = {}  # phase 18's largest tables, for phase 21
    large = large_grid_phase(torch, dev, kernels, flush, model, rig_models,
                             image_hw, large_edges, keep=stretch)
    large["seconds"] = time.perf_counter() - t0
    print(f"  phase 18 in {large['seconds']:.1f} s")

    # -- [19] intrinsic calibration ----------------------------------------
    print(f"[19] intrinsic calibration on boards rendered at the real "
          f"cameras' poses: detect_chessboard, calibrate_camera, "
          f"calibrate_video_photometric ({calib_iters} steps)", flush=True)
    calibration = calibration_phase(torch, dev, calib_hw, calib_views,
                                    calib_iters, keep=kept)
    print(f"  phase 19 in {calibration['seconds']:.1f} s")

    # -- [20] extrinsic calibration, MOG2 and KNN -------------------------
    print(f"[20] extrinsic calibration on boards rendered at the rig's "
          f"committed poses ({ext_cams} cameras at {ext_hw[1]}x{ext_hw[0]}, "
          f"{ext_iters} photometric steps), extrinsics_eval, MOG2, KNN and "
          "BackgroundPipeline", flush=True)
    extrinsics = extrinsics_phase(
        torch, dev, bg_seqs, model_tr.bg_states, model_tr.mog_params[0],
        frame0, r.states, rig_models.models, rig_models.frames[0],
        mask_params or DEFAULT_MASK_PARAMS, ext_hw, ext_cams, ext_iters,
        ext_bg_frames, ext_grid, keep=kept)
    print(f"  phase 20 in {extrinsics['seconds']:.1f} s")

    # -- [21] the sharded production step ----------------------------------
    print(f"[21] the sharded production step: ShardedRunner on a one-rank "
          f"group over the rig's {RIG_FRAMES} frames, {SHARD_COUNTS} shards "
          "emulated on one card", flush=True)
    t0 = time.perf_counter()
    sharded, k1_err21, k2_err21 = sharded_phase(torch, dev, kernels, flush,
                                                rig_models, stretch or None)
    del stretch
    sharded["seconds"] = time.perf_counter() - t0
    k1_err, k2_err = max(k1_err, k1_err21), max(k2_err, k2_err21)
    sharded_launches = sharded["runner"]["launches"]["strided"]
    print(f"  phase 21 in {sharded['seconds']:.1f} s")

    # -- [22] the viewer's headless render ----------------------------------
    print(f"[22] the viewer's headless render: the rig at {viewer_grid}^3 "
          f"along an orbit of {RIG_FRAMES} eyes and {viewer_points} lattice "
          f"points, at {viewer_hw[1]}x{viewer_hw[0]}", flush=True)
    viewer_render = viewer_render_phase(torch, dev, rig_models, image_hw,
                                        viewer_grid, viewer_hw, viewer_points)
    print(f"  phase 22 in {viewer_render['seconds']:.1f} s")

    # -- [23] the CLI on video files -----------------------------------------
    print(f"[23] the CLI on a rig directory of MJPEG videos: 4 x "
          f"{cli_frames[0]} background and {cli_frames[1]} video frames at "
          f"{RIG_HW[1]}x{RIG_HW[0]}, --grid {cli_grid}; calibrate on the "
          "extrinsics' scene", flush=True)
    cli_report = cli_phase(
        torch, dev, kernels, bg_frames=cli_frames[0],
        video_frames=cli_frames[1], grid_edge=cli_grid,
        offline_nf=cli_nf[0], batched=cli_nf[1], cpu_frames=cli_nf[2],
        ext_hw=ext_hw, ext_cams=ext_cams, ext_bg_frames=ext_bg_frames)
    print(f"  phase 23 in {cli_report['seconds_phase']:.1f} s")
    launches_cli = cli_report["launches_cli"]

    # -- [24] the manual corner session and the reports ---------------------
    expect(sorted(kept) == ["board", "discard", "masks", "rig_tris"]
           and list(kept["masks"]) == list(REPORT_MODELS)
           and len(kept["rig_tris"]) > 0,
           "phases 16, 19 and 20 hand phase 24 cam1's boards, its discard "
           f"views, the {'/'.join(REPORT_MODELS)} masks and the rig's mesh")
    print(f"[24] the manual corner session and the reports on "
          f"{dev.type}: {SESSION_VIEWS} board views of phase 19, the "
          f"{'/'.join(REPORT_MODELS)} masks of phase 20, the "
          f"intrinsics plot, the rig's mesh of phase 16 "
          f"({len(kept['rig_tris'])} triangles)", flush=True)
    reports_report = reports_phase(torch, dev, kept["board"],
                                   kept["discard"], kept["masks"],
                                   kept["rig_tris"])
    print(f"  phase 24 in {reports_report['seconds']:.1f} s")
    del kept

    def row(k, name, replaces, err, ms, plain_ms, bound_ms, bound_by, n,
            prof=None, prof_name="", **more):
        """``profiler_ms``: the ms per launch that profile ``prof`` gives
        the kernel whose name holds ``prof_name`` (None where none saw it)."""
        own = (prof or {}).get("own_kernels_ms_per_launch", {})
        return {"name": name, "route": "cuda",
                "source": f"vbr_tpu_torch/csrc/{k.source.name}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "profiler_ms": next((v for key, v in own.items()
                                     if prof_name and prof_name in key), None),
                **more}

    return {
        "kernels": [
            row(cb.K1, "K1 carve_blocked", "vbr_tpu/ops/carve_pallas.py:673",
                k1_err, k1_ms, k1_plain_ms, k1_bound, k1_bound_by,
                launches[0], profile, "carve_blocked_kernel", launch=k1_plan,
                launches_sharded=sharded_launches["carve_blocked"],
                launches_cli=launches_cli["carve_blocked"]),
            row(ccl_label.K2, "K2 ccl_combined",
                "vbr_tpu/ops/ccl_pallas.py:143", k2_err, k2_ms, k2_plain_ms,
                k2_bound, k2_bound_by, launches[1], profile, "CombinedRule",
                kernel_route=k2_route,
                launches_sharded=sharded_launches["ccl_combined"],
                launches_cli=launches_cli["ccl_combined"]),
            row(gmm.K3, "K3 mog_train", "vbr_tpu/ops/gmm.py:435", k3_err,
                k3_ms, k3_plain_ms, k3_bound, k3_bound_by, k3_launches,
                k3_profile, "mog_train_kernel", launch=k3_plan,
                launches_cli=launches_cli["mog_train"]),
            row(cb.K4, "K4 carve_frames", "vbr_tpu/ops/carve_pallas.py:1212",
                k4_err, k4_ms, k4_plain_ms, k4_bound, k4_bound_by,
                k4_launches, offline_profile, "carve_frames_kernel",
                launch=k4_plan, launches_cli=launches_cli["carve_frames"]),
            row(ccl_label.K5, "K5 ccl_label", "vbr_tpu/ops/ccl_pallas.py:67",
                k5_err, k5_ms, k5_plain_ms, k5_bound, k5_bound_by,
                k5_launches, kernel_route=k5_route,
                launches_cli=launches_cli["ccl_label"]),
        ],
        "clock": {"launch_floor_ms": launch_floor_ms,
                  "k1_ms_zeroing_flush": k1_ms_zeroing_flush},
        "main_path": {"process_frame_fast_ms": step_ms,
                      "stream_ms_per_frame": stream_ms,
                      "stream_frames": STREAM_FRAMES,
                      "profile": profile},
        "training": {"frames_per_camera": train_frames, "seconds": train_s,
                     "k3_profile": k3_profile},
        "offline": {"ms_per_frame": offline_ms, "frames": STREAM_FRAMES,
                    "frames_per_launch": OFFLINE_NF,
                    "launches": off_launches, "profile": offline_profile},
        "seam": seam,
        "surface": surface,
        "viewer": viewer,
        "large_grid": large,
        "calibration": calibration,
        "extrinsics": extrinsics,
        "sharded": sharded,
        "viewer_render": viewer_render,
        "cli": cli_report,
        "reports": reports_report,
    }


def profile_step(torch, step, step_ms, title, frames=4, frames_per_step=1,
                 top=15):
    """``torch.profiler`` over steps covering ``frames`` frames: device
    time per frame by kernel, and the device's idle share of the
    unprofiled time per frame ``step_ms`` (the profiler's own host cost is
    left out)."""
    from torch.profiler import ProfilerActivity, profile

    print(title, flush=True)
    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames // frames_per_step):
            step()
    rows = []
    for ev in prof.key_averages():  # device-side events only (no op rows)
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if str(ev.device_type).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us / 1e3 / frames, ev.count / frames, ev.key))
    if not rows:
        print("  the profiler saw no device time")
        return None
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    print(f"  device busy {busy_ms:.3f} ms/frame of {step_ms:.3f} ms "
          f"(unprofiled), idle share {1 - busy_ms / step_ms:.3f}; "
          f"{n_ops:.0f} device ops/frame")
    for ms, n, name in rows[:top]:
        print(f"  {ms:9.4f} ms/frame  x{n:<6.4g} {name[:90]}")
    # the profiler's own duration of the port's kernels (L2 as the step
    # leaves it), to hold against the event times of ``timed_ms``
    own = {" ".join(re.findall(r"\w+_kernel|\w+Rule", name)[:2]): ms / n
           for ms, n, name in rows if any(k in name for k in OWN_KERNELS)}
    print("  profiler ms per launch: " + ", ".join(
        f"{k} {v:.4f}" for k, v in own.items()))
    return {"device_busy_ms_per_frame": busy_ms,
            "own_kernels_ms_per_launch": own,
            "idle_share": 1 - busy_ms / step_ms,
            "device_ops_per_frame": n_ops,
            "top": [{"name": name[:90], "ms_per_frame": ms, "calls": n}
                    for ms, n, name in rows[:top]]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import vbr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the vbr_tpu_torch package is missing ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    print("[1] device", flush=True)
    card = card_line()
    if card is None:
        print("chip_smoke: nvidia-smi failed", file=sys.stderr)
        return 1
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    try:
        report = run("cuda")
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"  all phases in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
