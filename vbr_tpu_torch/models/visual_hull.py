"""VisualHull — background training, the live per-frame step and the
offline whole-sequence path of the visual-hull model.

Counterpart of ``vbr_tpu/models/visual_hull.py::VisualHull``: a calibrated
rig + per-camera background models (trained here by ``train_background``
through kernel K3, or loaded) + carve tables, with the per-frame step

    frames (C,H,W,3) u8 → HSV → compressed frozen MOG apply →
    pre-morphology → CCL cleanup (kernel K2) → post-morphology →
    blocked carve (kernel K1) → occupancy + colours

``process_frame_fast`` and ``stream`` run that step (``_full_step``, the
counterpart of ``_full_step_pallas`` with ``ingest="bgr"``) and redo a
frame exactly through the host cleanup when a camera overflows the
device component tables.  On a grid whose dims are not divisible by
8·sup there are no blocked tables: ``process_frame_fast`` then runs the
table step (``_full_step_tables``: the same mask stages, then the f64
table carve), and ``stream`` and ``process_frames_offline`` refuse.
``process_frame`` is the plain f64 table path.  ``VisualHull(cache_dir=)``
keeps the f64 tables in the JAX package's npz cache.  Their outputs are
torch tensors on the model's device.
``process_frames_offline`` runs the mask stages over every (frame, camera)
image of a chunk and carves the chunk in one launch of kernel K4
(``_full_step_frames``); it returns host arrays.

The surface entry points turn the carved hull into a triangle mesh (the
live counterpart of the reference's offline
``skimage.measure.marching_cubes`` call, voxel_reconstruction.py:142):
``process_frame_surface`` and ``stream_surface`` run the step that
``process_frame_fast`` runs with ``ops.marching_cubes.surface_program``
behind it (or ``_encode_surface_wire`` for ``transfer="wire"``), so the
mesh comes out of the same queue of device work that carved the hull; the
host only places the triangles in the world (two f32 roundings), meshes a
surface over the ``capacity`` with ``extract_mesh`` and redoes a frame
that overflows a component table.
``extract_surface``, ``textured_frame`` and ``viewer_arrays`` run on the
plain table path.

``stream_viewer`` is the thin-link viewer stream: per frame the step ends
in the packed viewer wire (``carve_blocked.pack_blocked_outputs`` +
``encode_wire``, ~0.33 MB at 128³ where the blocked outputs are 8.4 MB),
downloaded into pinned memory while the next frames run, and unpacked on
the host into the viewer's (positions, rgb).  It and ``stream_surface``
take the reduced-byte uploads ``ingest="yuv420"`` (the YUV 4:2:0 wire
format, half the bytes) and ``"yuv420_roi"`` (a fixed window per camera
placed by ``utils.roi.MotionROITracker``); both are lossy, and
``validate_reduced_ingest`` measures what they change.

``sharded_runner`` returns a ``ShardedRunner``: the same step over a
``(data, cam, grid)`` mesh of ranks (``parallel.pallas_sharded``), one
shard on each rank's device, with a superblock placement that can be
re-balanced; every rank gets numpy blocked outputs of the whole batch.

The host records its own spans and counters (``utils.profiling``, which
lists them): the step functions' stages (``masks``, ``cleanup``,
``finalize``, ``carve``) wherever they run, each upload, each exact redo
(``redo`` and the ``redos`` counter), the live step whole (``step``) and
its wait for the overflow bits, and the offline path's call, chunks,
downloads, copies and colour gathers.
"""

from __future__ import annotations

import collections
import functools
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.ops import carve_blocked, ccl, texturing
from vbr_tpu_torch.ops import color as color_ops
from vbr_tpu_torch.ops import marching_cubes as mc
from vbr_tpu_torch.ops.gmm import MOGState
from vbr_tpu_torch.parallel import pallas_sharded
from vbr_tpu_torch.parallel.carve_sharded import axis_size
from vbr_tpu_torch.pipelines import background, reconstruction
from vbr_tpu_torch.utils import artifacts, profiling
from vbr_tpu_torch.utils.config import (
    DEFAULT_MASK_PARAMS,
    CameraParams,
    GridConfig,
    MaskParams,
    MOGParams,
    RigConfig,
)
from vbr_tpu_torch.utils.device import resolve_device
from vbr_tpu_torch.utils.profiling import span
from vbr_tpu_torch.utils.roi import MotionROITracker

_UNBUILT = object()  # blocked tables not asked for yet
INGESTS = ("bgr", "yuv420", "yuv420_roi")  # the streams' upload formats


class VisualHull:
    """Multi-camera visual-hull reconstruction model."""

    def __init__(
        self,
        cameras: Sequence[CameraParams],
        grid: GridConfig = GridConfig(),
        rig: RigConfig = RigConfig(),
        mask_params: Sequence[MaskParams] = DEFAULT_MASK_PARAMS,
        cache_dir: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cameras = list(cameras)
        self.grid = grid
        self.rig = rig
        self.mask_params = list(mask_params)
        self.cache_dir = cache_dir
        self.bg_states: List[MOGState] = []
        self.mog_params: List[MOGParams] = []
        self._tables = None  # f64 table path, built on first use
        # blocked carve tables, built on the first fast step; None where
        # the grid cannot be blocked
        self._btab = _UNBUILT
        self._stacked_fz = None
        self._tex_tables = None  # texturing tables, built on first use

    @property
    def image_hw(self):
        return (self.rig.image_height, self.rig.image_width)

    @property
    def tables(self) -> carve_ops.ProjectionTables:
        """The projection tables, built on the model's device (exact: f32
        projection, f64 recheck of the boundary band); with ``cache_dir``
        loaded from (or built into) the npz cache both packages share."""
        if self._tables is None:
            if self.cache_dir:
                self._tables = artifacts.cached_projection_tables(
                    self.cameras, self.grid, self.image_hw, self.cache_dir,
                    self.device)
            else:
                self._tables = carve_ops.build_projection_tables(
                    self.cameras, self.grid, self.image_hw, accelerate=True,
                    device=self.device)
        return self._tables

    def _frames(self, frames) -> torch.Tensor:
        """u8 frames on the model's device.  A host array goes to the card
        through pinned memory, asynchronously: the host does not wait for
        the copy, and the pinned buffer is kept until it has landed."""
        with span("upload"):
            if isinstance(frames, torch.Tensor):
                return frames.to(self.device, torch.uint8)
            host = torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
            if self.device.type != "cuda":
                return host
            return host.pin_memory().to(self.device, non_blocking=True)

    def _ensure_fast_state(self):
        if self._stacked_fz is None:
            self._fig_thresholds = tuple(
                float(p.figure_threshold) for p in self.mask_params)
            self._inner_thresholds = tuple(
                float(p.inner_threshold) for p in self.mask_params)
            p0 = self.mog_params[0]
            fields = ("bg_ratio", "use_hsv", "match_sigma")
            for p in self.mog_params[1:]:
                if any(getattr(p, f) != getattr(p0, f) for f in fields):
                    raise ValueError(
                        "the batched mask stage needs uniform MOG apply "
                        "params (bg_ratio, use_hsv, match_sigma) across "
                        f"cameras; got {[(q.bg_ratio, q.use_hsv, q.match_sigma) for q in self.mog_params]}"
                    )
            self._stacked_fz = background.stack_frozen(
                self.bg_states, p0, self.device)

    def _ensure_btab(self):
        """The blocked carve tables, built at first call (on the device from
        256³, on the host below); None where the grid (or the image) does
        not fit their geometry.  A device build that fails its f64 spot
        check raises ``AssertionError``, which is not caught here."""
        if self._btab is _UNBUILT:
            sub = (8, 8, 8)
            sup = tuple(max(1, min(p, n // s))
                        for n, s, p in zip(self.grid.shape, sub, (2, 2, 4)))
            try:
                self._btab = carve_blocked.build_block_tables(
                    self.cameras, self.grid, self.image_hw, sub=sub, sup=sup,
                    color_camera=self.rig.color_camera, accelerate=None,
                    device=self.device,
                )
            except ValueError:  # e.g. grid dims not divisible by 8·sup
                self._btab = None
        return self._btab

    def _blocked_tables_for(self, what: str):
        """The blocked tables, or a ``ValueError`` naming what needs them."""
        btab = self._ensure_btab()
        if btab is None:
            raise ValueError(
                f"{what} needs grid dims divisible by 8·sup (8-divisible; got "
                f"{self.grid.shape}); use process_frame_fast or process_frame")
        return btab

    # -- setup ------------------------------------------------------------

    @classmethod
    def from_data_dir(cls, data_dir: str, grid: GridConfig = GridConfig(),
                      train_background: bool = True, **kw) -> "VisualHull":
        """A model of the rig in ``data_dir`` (``cam*/config.xml``); ``kw``
        goes to the constructor.  With ``train_background`` each camera's
        model is trained on ``cam*/background.avi`` (kernel K3); without,
        call :meth:`load_background_models` or :meth:`train_background`."""
        model = cls(reconstruction.load_rig(data_dir), grid, **kw)
        if train_background:
            model.train_background(data_dir)
        return model

    def train_background(self, source):
        """Train one MOG model per camera with ``MOGParams(history=T_c)``;
        sets ``bg_states`` / ``mog_params``.  ``source`` is a data
        directory, whose ``cam{c}/background.avi`` is decoded (as
        ``vbr_tpu`` trains), or one decoded background sequence per camera,
        ``source[c]`` (T_c, H, W, 3) u8 BGR."""
        if isinstance(source, (str, os.PathLike)):
            from vbr_tpu_torch.utils import video as vio

            data_dir = source
            source = (vio.read_video(os.path.join(  # one camera at a time
                data_dir, f"cam{cam}", "background.avi"))
                for cam in range(1, self.rig.num_cameras + 1))
        elif len(source) != self.rig.num_cameras:
            raise ValueError(
                f"expected {self.rig.num_cameras} background sequences, got "
                f"{len(source)}")
        self.bg_states = []
        self.mog_params = []
        for frames in source:
            p = MOGParams(history=frames.shape[0])
            self.bg_states.append(background.train_background_model(
                frames, p, device=self.device))
            self.mog_params.append(p)
        self._stacked_fz = None

    # -- per-frame step ---------------------------------------------------

    def masks(self, frames, ccl_backend: str = "device") -> torch.Tensor:
        """(C, H, W) u8 cleaned masks on the model's device.

        ``ccl_backend="device"`` (default) runs the mask stages of all
        cameras at once with the device cleanup (kernel K2), each overflowed
        camera redone exactly by the host cleanup; ``"host"`` and
        ``"device-xla"`` run ``background.extract_foreground_mask`` camera
        by camera with that cleanup route, each camera's background model
        on the model's device.  All three give the same masks."""
        frames_d = self._frames(frames)
        if ccl_backend != "device":
            return torch.stack([
                background.extract_foreground_mask(
                    MOGState(*(t.to(self.device) for t in self.bg_states[c])),
                    frames_d[c], self.mask_params[c], self.mog_params[c],
                    ccl_backend=ccl_backend)
                for c in range(frames_d.shape[0])])
        self._ensure_fast_state()
        raw = background.raw_masks_batched_fz(
            self._stacked_fz, frames_d, self.mask_params,
            self.mog_params[0].use_hsv)
        cleaned, ovf = ccl.clean_masks_batched(
            raw, self._fig_thresholds, self._inner_thresholds)
        masks = background.finalize_masks_batched(cleaned, self.mask_params)
        ovf = ovf.cpu().numpy()
        if ovf.any():
            raw_h = raw.cpu().numpy()
            for c in np.flatnonzero(ovf):
                profiling.count("host_cleanups")
                p = self.mask_params[c]
                cleaned_c = ccl.clean_mask_host(
                    raw_h[c], p.figure_threshold, p.inner_threshold)
                masks[c] = background.finalize_masks_batched(
                    torch.from_numpy(cleaned_c)[None].to(self.device), (p,))[0]
        return masks

    def process_frame(self, frames, masks=None):
        """Plain table-path step → (occupancy (N,) bool, colors (N, 3) u8)."""
        frames_d = self._frames(frames)
        masks = self.masks(frames_d) if masks is None else self._frames(masks)
        return carve_ops.carve_from_tables(
            masks, frames_d, self.tables.valid, self.tables.lin_idx,
            views_threshold=self.rig.views_threshold,
            color_camera=self.rig.color_camera,
        )

    def _dispatch(self, frames_d, layout, ingest="bgr", roi_offsets=None):
        return _full_step(
            self._stacked_fz, frames_d, self._btab,
            mask_params=self.mask_params,
            use_hsv=self.mog_params[0].use_hsv,
            fig_thresholds=self._fig_thresholds,
            inner_thresholds=self._inner_thresholds,
            views_threshold=self.rig.views_threshold, layout=layout,
            ingest=ingest, roi_offsets=roi_offsets,
        )

    def _redo(self, frames_d, layout):
        """Exact redo of an overflowed frame via the host cleanup."""
        with span("redo"):
            profiling.count("redos")
            return carve_blocked.carve_blocked(
                self.masks(frames_d), frames_d[self.rig.color_camera],
                self._btab, views_threshold=self.rig.views_threshold,
                layout=layout,
            )

    def _redo_tables(self, frames_d):
        """Exact redo of an overflowed frame on the plain table path."""
        with span("redo"):
            profiling.count("redos")
            return self.process_frame(frames_d)

    def process_frame_fast(self, frames, layout: str = "canonical",
                           carve_kernel: str = "auto"):
        """The fused per-frame step → (occ, colors).

        ``carve_kernel="blocked"`` carves with kernel K1 on the blocked
        tables and returns ``layout`` order (see
        ``carve_blocked.carve_blocked``); ``"tables"`` runs the table step
        (the f64 table carve after the same mask stages) and returns
        canonical order whatever ``layout``; ``"auto"`` takes the blocked
        carve where the grid has blocked tables and the table step where it
        has not (dims not divisible by 8·sup).  Recorded as a ``step``
        span (``utils.profiling``)."""
        with span("step"):
            carve_kernel = self._carve_kernel(carve_kernel)
            frames_d = self._frames(frames)
            occ, col, ovf = self._step(frames_d, carve_kernel, layout)
            with span("overflow_wait"):
                overflowed = bool(ovf.any())
            if overflowed:  # exact redo through the host cleanup
                if carve_kernel == "tables":
                    return self._redo_tables(frames_d)
                return self._redo(frames_d, layout)
            return occ, col

    def _carve_kernel(self, carve_kernel):
        """``carve_kernel`` of :meth:`process_frame_fast` with ``"auto"``
        resolved (the fast state built on the way)."""
        self._ensure_fast_state()
        if carve_kernel == "auto":
            carve_kernel = ("tables" if self._ensure_btab() is None
                            else "blocked")
        if carve_kernel not in ("blocked", "tables"):
            raise ValueError(f"unknown carve_kernel {carve_kernel!r}")
        if carve_kernel == "blocked":
            self._blocked_tables_for("the blocked carve")
        return carve_kernel

    def _step(self, frames_d, carve_kernel="auto", layout="canonical",
              ingest="bgr", roi_offsets=None):
        """Queue the fused per-frame step on an upload in format ``ingest``
        → (occ, col, ovf) on the model's device: kernels K2 and K1 on the
        blocked tables (their plain versions on a CPU model), or the table
        step (``"tables"``, which returns canonical order whatever
        ``layout``)."""
        if self._carve_kernel(carve_kernel) == "blocked":
            return self._dispatch(frames_d, layout, ingest, roi_offsets)
        return _full_step_tables(
            self._stacked_fz, frames_d, self.tables,
            mask_params=self.mask_params,
            use_hsv=self.mog_params[0].use_hsv,
            fig_thresholds=self._fig_thresholds,
            inner_thresholds=self._inner_thresholds,
            views_threshold=self.rig.views_threshold,
            color_camera=self.rig.color_camera,
            ingest=ingest, roi_offsets=roi_offsets,
        )

    def stream(self, frames_iter, layout: str = "blocked"):
        """Streaming reconstruction: frame N+1's step is queued on the
        device before frame N's overflow bits are read, so the host's
        decode and redo checks overlap device work.  Yields (occ, colors)
        per frame in ``layout`` order."""
        self._ensure_fast_state()
        self._blocked_tables_for("stream")
        pending = None
        for frames in frames_iter:
            frames_d = self._frames(frames)
            cur = (*self._dispatch(frames_d, layout), frames_d)
            if pending is not None:
                yield self._resolve(pending, layout)
            pending = cur
        if pending is not None:
            yield self._resolve(pending, layout)

    def sharded_runner(self, mesh, order: str = "strided",
                       costing_frames=None,
                       rebalance_every: int = 0) -> "ShardedRunner":
        """The fused step over a ``(data, cam, grid)`` mesh of ranks
        (``parallel.carve_sharded.make_carve_mesh``), one shard on each
        rank's device (this model's): frames over ``data``, the mask stage
        (kernel K2) over ``cam``, the carve (kernel K1) over the
        superblocks split over ``("cam", "grid")`` (see
        ``parallel.pallas_sharded``).  Returns a :class:`ShardedRunner`:

            ``runner(frames (F, C, H, W, 3) u8) -> (occ_b, col_b)``

        numpy blocked outputs in canonical superblock order with a leading
        frame axis (``F`` = the mesh's ``data`` size), on every rank, each
        frame bit-identical to ``process_frame_fast(layout="blocked")``; a
        frame that overflows a component table is redone exactly through
        the host cleanup.

        ``order``: ``"strided"`` (default, balanced without masks) |
        ``"cost"`` (capacity-bounded LPT; needs one (C, H, W, 3)
        ``costing_frames`` sample whose masks estimate each superblock's
        activity) | ``"contiguous"`` (z-major slabs).  A cost placement goes
        stale when the subject moves: ``runner.rebalance(frame)`` re-costs
        and re-places the tables, and ``rebalance_every=N > 0`` does it
        every N batches from the batch's first frame."""
        return ShardedRunner(self, mesh, order=order,
                             costing_frames=costing_frames,
                             rebalance_every=rebalance_every)

    def _resolve(self, entry, layout):
        occ, col, ovf, frames_d = entry
        if bool(ovf.any()):
            return self._redo(frames_d, layout)
        return occ, col

    # -- thin-link viewer stream -------------------------------------------

    def _roi_tracker(self, roi_hw):
        """The ROI tracker, classifying with the frozen model itself on a
        strided grid (``utils.roi``)."""
        fz = self._stacked_fz
        return MotionROITracker(
            carve_ops.to_host(fz.mean), carve_ops.to_host(fz.thr),
            carve_ops.to_host(fz.bcount), roi_hw,
            use_hsv=self.mog_params[0].use_hsv,
            figure_threshold=min(p.figure_threshold
                                 for p in self.mask_params))

    def _ingest_prepare(self, ingest, tracker, frames):
        """The host side of an upload → (mode, upload, roi offsets or
        None).  ``yuv420_roi`` falls back to ``yuv420`` on a frame whose
        foreground the tracker cannot hold in its windows."""
        if ingest == "bgr":
            return "bgr", frames, None
        frames = carve_ops.to_host(frames)
        if ingest == "yuv420_roi":
            offsets, full_needed = tracker.update(frames)
            if not full_needed:
                return ("yuv420_roi",
                        color_ops.bgr_to_yuv420_host(tracker.crop(frames)),
                        offsets)
        return "yuv420", color_ops.bgr_to_yuv420_host(frames), None

    def stream_viewer(self, frames_iter, depth: int = 3,
                      ingest: str = "bgr", roi_hw=(320, 224)):
        """Streaming viewer arrays for a thin link: frames (C, H, W, 3) u8
        in, the viewer's ``(positions, rgb)`` out, in the rows of
        ``carve_blocked.compact_voxels_blocked`` (blocked order).

        Each frame's step (kernels K2 and K1) ends in the packed viewer
        wire (``carve_blocked.pack_blocked_outputs`` + ``encode_wire``:
        ~0.33 MB at 128³), whose download into pinned memory is queued at
        once; ``depth`` frames stay in flight, and a frame is unpacked on
        the host when it leaves the queue.  A frame whose cleanup overflows
        a component table, or whose wire overflows a capacity, is redone
        exactly from its BGR frames (host cleanup, uncompressed carve).

        ``ingest="yuv420"`` uploads the YUV 4:2:0 pack (half the bytes),
        unpacked on the device inside the step; ``"yuv420_roi"`` uploads
        only a ``roi_hw`` window of each camera, placed by a
        ``utils.roi.MotionROITracker`` seeded by the frozen model, and falls
        back to the full ``yuv420`` upload on frames whose foreground the
        windows cannot hold.  Both are lossy: hold them to
        :meth:`validate_reduced_ingest` on representative frames first.
        The viewer's colours come from the reconstructed frames."""
        if ingest not in INGESTS:
            raise ValueError(f"unknown ingest format {ingest!r}")
        self._ensure_fast_state()
        self._blocked_tables_for("stream_viewer")
        tracker = (self._roi_tracker(roi_hw) if ingest == "yuv420_roi"
                   else None)
        q = collections.deque()

        def dispatch(frames):
            # the BGR frames ride along for the exact fallback; only the
            # upload takes the reduced format
            mode, upload, roi_off = self._ingest_prepare(ingest, tracker,
                                                         frames)
            wire = self._dispatch(self._frames(upload), "packed", mode,
                                  roi_off)
            (wire,), ready = _start_download((wire,))
            return wire, ready, frames

        def resolve(entry):
            wire, ready, frames = entry
            _wait(ready)
            (any_ovf, n_blocks, n_vox, ids, packed_k,
             cols) = carve_blocked.decode_wire(
                wire, total_voxels=self.grid.num_voxels)
            if any_ovf:
                occ, col = self._redo(self._frames(frames), "blocked")
                return carve_blocked.compact_voxels_blocked(
                    occ, col, self._btab, self.grid,
                    self.rig.scaling_factor)
            return carve_blocked.viewer_arrays_from_packed(
                packed_k, ids, n_blocks, n_vox, cols, self._btab, self.grid,
                self.rig.scaling_factor)

        for frames in frames_iter:
            q.append(dispatch(frames))
            if len(q) > depth:
                yield resolve(q.popleft())
        while q:
            yield resolve(q.popleft())

    def validate_reduced_ingest(self, frames, ingest: str = "yuv420",
                                roi_hw=(320, 224)):
        """What a reduced-byte ingest changes on ``frames`` (C, H, W, 3)
        u8, measured where it matters: the cleaned masks and the carved
        hull (the f64 table carve), on the model's device.  Returns a dict:

          mask_iou        per-camera IoU of the cleaned masks (BGR against
                          the reduced upload)
          mask_iou_min    their minimum
          occ_diff_voxels voxels whose occupancy differs
          occ_exact       occupied voxels from the BGR frames
          max_channel_err max |reconstructed − original| over the pixels
                          (inside the windows, for ``"yuv420_roi"``)

        For ``"yuv420_roi"`` one tracker update places the windows; its
        full-frame signal (always set on a first frame) is ignored, since
        the guard measures the ROI path's loss at that placement."""
        self._ensure_fast_state()
        frames = carve_ops.to_host(frames)
        frames_d = self._frames(frames)
        image_hw = tuple(frames.shape[1:3])

        def masks_of(raw):
            cleaned, _ = ccl.clean_masks_batched(
                raw, self._fig_thresholds, self._inner_thresholds)
            return background.finalize_masks_batched(cleaned,
                                                     self.mask_params)

        use_hsv = self.mog_params[0].use_hsv
        m_exact = masks_of(background.raw_masks_batched_fz(
            self._stacked_fz, frames_d, self.mask_params, use_hsv))
        region = torch.ones(frames.shape[:3], dtype=torch.bool,
                            device=self.device)
        if ingest == "yuv420_roi":
            tracker = self._roi_tracker(roi_hw)
            offsets, _ = tracker.update(frames)
            rois = color_ops.yuv420_to_bgr_u8(self._frames(
                color_ops.bgr_to_yuv420_host(tracker.crop(frames))))
            m_red = masks_of(background.raw_masks_batched_fz_roi(
                self._stacked_fz, rois, offsets, self.mask_params, use_hsv,
                image_hw=image_hw))
            recon = background.paste_rois(rois, offsets, image_hw)
            region = torch.zeros_like(region)
            for c, (y0, x0) in enumerate(offsets.tolist()):
                region[c, y0:y0 + roi_hw[0], x0:x0 + roi_hw[1]] = True
        elif ingest == "yuv420":
            recon = color_ops.yuv420_to_bgr_u8(self._frames(
                color_ops.bgr_to_yuv420_host(frames)))
            m_red = masks_of(background.raw_masks_batched_fz(
                self._stacked_fz, recon, self.mask_params, use_hsv))
        else:
            raise ValueError(f"unknown reduced ingest {ingest!r}")
        err = (recon.to(torch.int32) - frames_d.to(torch.int32)).abs()
        chan_err = int(err.amax(dim=-1)[region].max())
        a, b = m_exact > 0, m_red > 0
        inter = (a & b).sum(dim=(1, 2)).tolist()
        union = (a | b).sum(dim=(1, 2)).tolist()
        ious = [float(i / u) if u else 1.0 for i, u in zip(inter, union)]
        t = self.tables
        carve = functools.partial(
            carve_ops.carve_from_tables, valid=t.valid, lin_idx=t.lin_idx,
            views_threshold=self.rig.views_threshold,
            color_camera=self.rig.color_camera)
        occ_e, _ = carve(m_exact, frames_d)
        occ_r, _ = carve(m_red, recon)
        return {
            "mask_iou": [round(x, 6) for x in ious],
            "mask_iou_min": round(min(ious), 6),
            "occ_diff_voxels": int((occ_e != occ_r).sum()),
            "occ_exact": int(occ_e.sum()),
            "max_channel_err": chan_err,
        }

    # -- offline whole-sequence path ---------------------------------------

    def process_frames_offline(self, frames: np.ndarray,
                               frames_per_launch: int = 8,
                               with_colors: bool = True):
        """Batched reconstruction of a frame sequence (F, C, H, W, 3) u8.

        Frames go through in chunks of ``frames_per_launch``: the mask
        stages run over every (frame, camera) image of the chunk and one
        launch of kernel K4 carves all its frames (the last chunk is
        padded by repeating the last frame; those outputs are dropped).
        Per-frame occupancy equals :meth:`process_frame`; a frame that
        overflows a component table is redone exactly through it.

        Colours are gathered on the host from the colour camera's frame at
        occupied voxels only.  Returns ``(occ, colors)``: ``occ`` (F, N)
        bool canonical occupancy and ``colors`` a per-frame list of
        ``(idx (M_f,) i64, col (M_f, 3) u8 BGR)``, or None with
        ``with_colors=False``; all numpy.  Needs grid dims divisible by 8·sup
        (``ValueError`` otherwise).  Recorded as an ``offline`` span
        (``utils.profiling``)."""
        with span("offline"):
            self._ensure_fast_state()
            self._blocked_tables_for("process_frames_offline")
            frames = np.asarray(frames)
            F = frames.shape[0]
            NF = int(frames_per_launch)
            pad = (-F) % NF
            frames_p = frames
            if pad:
                with span("pad"):
                    frames_p = np.concatenate(
                        [frames, np.repeat(frames[-1:], pad, axis=0)])
            occ_chunks, ovf_chunks = [], []
            for s in range(0, F + pad, NF):
                with span("chunk"):
                    occ_c, ovf_c = _full_step_frames(
                        self._stacked_fz, self._frames(frames_p[s:s + NF]),
                        self._btab, mask_params=self.mask_params,
                        use_hsv=self.mog_params[0].use_hsv,
                        fig_thresholds=self._fig_thresholds,
                        inner_thresholds=self._inner_thresholds,
                        views_threshold=self.rig.views_threshold,
                    )
                    with span("download"):
                        occ_chunks.append(occ_c.cpu().numpy())
                        ovf_chunks.append(ovf_c.cpu().numpy())
            with span("concat"):
                occ = np.concatenate(occ_chunks)[:F]
                ovf = np.concatenate(ovf_chunks)[:F]
            for f in np.flatnonzero(ovf.any(axis=1)):  # exact redo, rare
                occ[f] = self._redo_tables(frames[f])[0].cpu().numpy()
            if not with_colors:
                return occ, None
            with span("colors"):
                lin_idx = self.tables.lin_idx.cpu().numpy()
                cc = self.rig.color_camera
                colors = [carve_blocked.frame_colors_host(
                    occ[f], frames[f][cc], lin_idx, color_camera=cc)
                    for f in range(F)]
            return occ, colors

    # -- surface ------------------------------------------------------------

    def _world_frame(self):
        """(origin, spacing) of the voxel grid in world mm (floats)."""
        xs, ys, zs = self.grid.axis_ranges()
        return (
            (float(xs[0]), float(ys[0]), float(zs[0])),
            (float(xs[1] - xs[0]), float(ys[1] - ys[0]),
             float(zs[1] - zs[0])),
        )

    def _surface_redo(self, frames_d, occ, col, recarve, algorithm,
                      ambiguity):
        """Exact fallback of the surface step (rare) → (tris, occ, col).
        With ``recarve`` (a component-table overflow, or a reduced upload)
        the BGR frames ``frames_d`` are carved again on the plain table
        path; otherwise (a surface over the ``capacity`` or the block limit)
        the step's occupancy, which is exact, is kept.  Either is meshed
        with ``extract_mesh`` (the config grid on its device, the emission
        on the host)."""
        if recarve:
            occ, col = self._redo_tables(frames_d)
        origin, spacing = self._world_frame()
        tris, _ = mc.extract_mesh(occ.reshape(self.grid.shape), origin=origin,
                                  spacing=spacing, algorithm=algorithm,
                                  ambiguity=ambiguity)
        return tris, occ, col

    def process_frame_surface(self, frames, algorithm: str = "cubes",
                              ambiguity: str = "join",
                              capacity: int = 32768):
        """Frame → triangle mesh: the fused per-frame step of
        :meth:`process_frame_fast` (kernels K2 and K1 where the grid has
        blocked tables) and the device-resident surface extraction
        (``ops.marching_cubes.surface_program``) queued as one piece of
        device work, with no host round trip between carving and meshing.

        Returns ``(tris (T, 3, 3) f32 world mm numpy, occ, col)``, ``tris``
        bit-identical to :meth:`extract_surface` on the same frame.  A frame
        that overflows a device component table is redone on the plain
        table path; one with more than ``capacity`` active surface cells is
        meshed by ``extract_mesh`` from the same occupancy.
        ``("cubes", "join")`` is what skimage's Lewiner MC33 resolves on a
        binary volume (the reference's call, voxel_reconstruction.py:142);
        ``algorithm="tetrahedra"`` takes the 6-tet decomposition.
        """
        mc.table_emitter(algorithm, ambiguity, 0.5)  # validates the rule
        frames_d = self._frames(frames)
        occ, col, ovf = self._step(frames_d)
        verts, valid, n_active = mc.surface_program(
            occ.reshape(self.grid.shape), algorithm=algorithm,
            ambiguity=ambiguity, capacity=capacity)
        (verts, valid, n_active, ovf), ready = _start_download(
            (verts, valid, n_active, ovf))
        _wait(ready)
        if bool(ovf.any()) or int(n_active) > capacity:
            return self._surface_redo(frames_d, occ, col, bool(ovf.any()),
                                      algorithm, ambiguity)
        origin, spacing = self._world_frame()
        return mc.world_triangles(verts, valid, origin, spacing), occ, col

    def stream_surface(self, frames_iter, depth: int = 2,
                       algorithm: str = "cubes", ambiguity: str = "join",
                       capacity: int = 32768, transfer: str = "full",
                       ingest: str = "bgr", roi_hw=(320, 224)):
        """Streaming surface reconstruction: frames in, meshes out.

        Each frame's step (that of :meth:`process_frame_surface`) is queued
        with ``depth`` frames in flight, and its results are copied into
        pinned host memory as soon as they are queued; a frame's overflow
        bits and active-cell count are read only when it leaves the queue.
        Yields ``(tris (T, 3, 3) f32 world mm, occ)`` per frame, equal to
        :meth:`process_frame_surface`, with its fallbacks.

        ``transfer="wire"`` downloads only the active cells' ids and
        configs and the bit-packed occupancy (``_encode_surface_wire``,
        ~0.43 MB at 128³ and the default capacity) instead of the emitted
        triangles (~7.1 MB), and the host emits the same triangles from the
        generated table (``native.mc_emit``); ``occ`` is then a numpy
        array.  ``ingest`` takes the reduced-byte uploads of
        :meth:`stream_viewer` (``"yuv420"``, ``"yuv420_roi"``; lossy, see
        :meth:`validate_reduced_ingest`), unpacked on the device inside the
        step on either carve; a frame that falls back is redone from its
        BGR frames, as in the JAX package.
        """
        if transfer not in ("full", "wire"):
            raise ValueError(f"unknown transfer mode {transfer!r}")
        if ingest not in INGESTS:
            raise ValueError(f"unknown ingest format {ingest!r}")
        mc.table_emitter(algorithm, ambiguity, 0.5)  # validates the rule
        self._ensure_fast_state()
        origin, spacing = self._world_frame()
        tracker = (self._roi_tracker(roi_hw) if ingest == "yuv420_roi"
                   else None)
        q = collections.deque()

        def dispatch(frames):
            mode, upload, roi_off = self._ingest_prepare(ingest, tracker,
                                                         frames)
            upload_d = self._frames(upload)
            occ, col, ovf = self._step(upload_d, ingest=mode,
                                       roi_offsets=roi_off)
            if transfer == "wire":
                out = (_encode_surface_wire(occ, ovf, self.grid.shape,
                                            capacity),)
            else:
                out = (*mc.surface_program(
                    occ.reshape(self.grid.shape), algorithm=algorithm,
                    ambiguity=ambiguity, capacity=capacity), ovf)
            host, ready = _start_download(out)
            # the BGR frames for a fallback: the upload itself, or the host
            # frames behind a reduced upload
            return host, ready, upload_d if mode == "bgr" else frames, occ, col

        def resolve(entry):
            host, ready, frames, occ, col = entry
            _wait(ready)
            if transfer == "wire":
                any_ovf, n_active, idx, cfg, occ_h = _decode_surface_wire(
                    host[0], capacity, self.grid.num_voxels)
            else:
                verts, valid, n_active, ovf = host
                any_ovf, n_active = bool(ovf.any()), int(n_active)
            if any_ovf or n_active > capacity:
                # the step's occupancy stands only for BGR frames
                tris, occ, _ = self._surface_redo(
                    self._frames(frames), occ, col,
                    bool(any_ovf) or ingest != "bgr", algorithm, ambiguity)
                return tris, (carve_ops.to_host(occ) if transfer == "wire"
                              else occ)
            if transfer == "wire":
                return mc.triangles_from_wire(
                    idx, cfg, n_active, self.grid.shape, origin, spacing,
                    algorithm=algorithm, ambiguity=ambiguity), occ_h
            return mc.world_triangles(verts, valid, origin, spacing), occ

        for frames in frames_iter:
            q.append(dispatch(frames))
            if len(q) > depth:
                yield resolve(q.popleft())
        while q:
            yield resolve(q.popleft())

    def extract_surface(self, frames, masks=None, algorithm: str = "cubes",
                        ambiguity: str = "join"):
        """Isosurface mesh of the plain table path's hull, in world mm:
        (tris (T, 3, 3) f32 numpy, T).  The default ``("cubes", "join")``
        is shared by every surface entry point."""
        occ, _ = self.process_frame(frames, masks)
        origin, spacing = self._world_frame()
        return mc.extract_mesh(occ.reshape(self.grid.shape), origin=origin,
                               spacing=spacing, algorithm=algorithm,
                               ambiguity=ambiguity)

    def textured_frame(self, frames, masks=None):
        """Carve (plain table path) + per-voxel colour from the nearest
        non-occluded camera, in place of the reference's colour camera
        for every voxel (assignment.py:133).

        Returns (occupancy (N,) bool, colors (N, 3) u8, cam_choice (N,)
        i8) on the model's device."""
        if self._tex_tables is None:
            self._tex_tables = texturing.build_texturing_tables(
                self.cameras, self.grid, self.image_hw, self.device)
        frames_d = self._frames(frames)
        occ, _ = self.process_frame(frames_d, masks)
        t = self._tex_tables
        colors, cam_choice = texturing.textured_colors(
            occ, frames_d, t.valid, t.lin_idx, t.depth,
            image_hw=self.image_hw)
        return occ, colors, cam_choice

    def viewer_arrays(self, frames, masks=None):
        """(positions, colors) numpy in viewer coordinates (the reference
        seam's contract) from the plain table path."""
        occ, col = self.process_frame(frames, masks)
        return carve_ops.compact_voxels(occ, col, self.grid,
                                        self.rig.scaling_factor)

    # -- checkpointing ----------------------------------------------------

    def save_background_models(self, out_dir: str):
        for c, st in enumerate(self.bg_states):
            artifacts.save_mog_state(
                os.path.join(out_dir, f"mog_cam{c + 1}.npz"), st)

    def load_background_models(self, out_dir: str) -> bool:
        """Load ``mog_cam{1..C}.npz`` (as written by either package);
        False when any is missing."""
        states = []
        for c in range(self.rig.num_cameras):
            st = artifacts.load_mog_state(
                os.path.join(out_dir, f"mog_cam{c + 1}.npz"), "cpu")
            if st is None:
                return False
            states.append(st)
        self.bg_states = states
        self.mog_params = [MOGParams() for _ in states]
        self._stacked_fz = None
        return True


class ShardedRunner:
    """The sharded fused step of one rank, callable, with a placement that
    can be re-balanced (built by :meth:`VisualHull.sharded_runner`; every
    rank of the mesh builds one and calls it on the same batches).

    Calling it on a (F, C, H, W, 3) u8 batch returns numpy ``(occ_b,
    col_b)`` blocked, in canonical superblock order.  A superblock order
    changes no bit of the results (every per-superblock table and the
    canonical index map move together), so re-placing is a copy of the
    tables:

      * :meth:`rebalance` — re-cost from a frame and re-place if the
        predicted critical path improves by ``min_gain``;
      * ``rebalance_every=N`` — that, every N batches, from the batch's
        first frame;
      * :meth:`shard_costs` / :meth:`imbalance` — the predicted per-shard
        load of the current placement under given costs.
    """

    def __init__(self, model: VisualHull, mesh, order: str = "strided",
                 costing_frames=None, rebalance_every: int = 0):
        if model.device.type != mesh.device_type:
            raise ValueError(
                f"the model is on {model.device}, the mesh on "
                f"{mesh.device_type} devices")
        self.model = model
        self.mesh = mesh
        self.mode = order
        self.rebalance_every = int(rebalance_every)
        self._runs = 0
        self._nshards = pallas_sharded.shard_count(mesh)
        model._ensure_fast_state()
        btab = model._blocked_tables_for("sharded_runner")
        costs = None
        if order == "cost":
            if costing_frames is None:
                raise ValueError(
                    "order='cost' needs a (C, H, W, 3) costing_frames "
                    "sample (its masks estimate per-superblock activity)")
            costs = self._costs_from(costing_frames)
        self.costs = costs
        self.order = pallas_sharded.superblock_order(
            btab.nsuper, self._nshards, order, costs=costs)
        self._st = pallas_sharded.shard_block_tables(mesh, btab,
                                                     order=self.order)
        self._step = pallas_sharded.sharded_production_step(
            mesh, use_hsv=model.mog_params[0].use_hsv,
            views_threshold=model.rig.views_threshold)
        # the frozen models and thresholds never change between batches:
        # placed once (tens of MB, not hot-path traffic)
        self._static_in = pallas_sharded.place_static_inputs(
            mesh, model._stacked_fz, model._fig_thresholds,
            model._inner_thresholds,
            pallas_sharded.mask_flags_array(model.mask_params))

    # -- placement inspection / maintenance -------------------------------

    def _costs_from(self, frame) -> np.ndarray:
        """Per-superblock carve costs from one (C, H, W, 3) frame."""
        return pallas_sharded.superblock_costs(
            self.model._btab, self.model.masks(frame),
            self.model.rig.views_threshold)

    def _per_shard(self, order, costs) -> np.ndarray:
        c = np.zeros(len(order), np.float64)
        c[: self.model._btab.nsuper] = costs
        return c[order].reshape(self._nshards, -1).sum(axis=1)

    def shard_costs(self, costs=None) -> np.ndarray:
        """(nshards,) predicted per-shard cost of the CURRENT placement
        under ``costs`` (default: the placement's own costing frame)."""
        costs = self.costs if costs is None else np.asarray(costs)
        if costs is None:
            raise ValueError(
                "no costs available (placement is not cost-based); pass "
                "costs or use rebalance(frame)")
        return self._per_shard(self.order, costs)

    def imbalance(self, costs=None) -> float:
        """Critical-path / mean predicted shard cost (1.0 = perfect)."""
        sc = self.shard_costs(costs)
        mean = sc.mean()
        return float(sc.max() / mean) if mean > 0 else 1.0

    def rebalance(self, frame, min_gain: float = 0.05) -> bool:
        """Re-cost from ``frame`` ((C, H, W, 3) u8) and re-place the
        tables if the predicted critical-path cost improves by at least
        ``min_gain`` (a fraction); True if re-placed.  Safe at any time:
        the results are the same bits under any placement."""
        costs = self._costs_from(frame)
        new_order = pallas_sharded.superblock_order(
            self.model._btab.nsuper, self._nshards, "cost", costs=costs)
        cur_crit = self.shard_costs(costs).max()
        new_crit = self._per_shard(new_order, costs).max()
        self.costs = costs  # the fresher costs, also when not re-placed
        if new_crit > (1.0 - min_gain) * cur_crit:
            return False
        self.mode = "cost"
        self.order = new_order
        self._st = pallas_sharded.shard_block_tables(
            self.mesh, self.model._btab, order=new_order)
        return True

    # -- the step ----------------------------------------------------------

    def _dispatch(self, frames):
        """Queue the sharded step on one (F, C, H, W, 3) batch and the
        downloads of its canonical blocked outputs."""
        D = axis_size(self.mesh, "data")
        if frames.shape[0] != D:
            raise ValueError(
                f"frame batch {frames.shape[0]} != data-axis size {D}")
        if (self.rebalance_every and self._runs
                and self._runs % self.rebalance_every == 0):
            self.rebalance(frames[0])
        self._runs += 1
        st = self._st
        occ_b, col_b, ovf = self._step(
            pallas_sharded.place_frames(self.mesh, frames), *self._static_in,
            st.tables)
        occ_b, col_b = pallas_sharded.unshuffle_blocked(
            occ_b, col_b, self.model._btab, st.order)
        outs, ready = _start_download((occ_b, col_b, ovf))
        return outs, ready, frames

    def _resolve(self, entry):
        """Wait for one dispatched batch; redo an overflowed frame exactly
        through the host cleanup."""
        outs, ready, frames = entry
        _wait(ready)
        occ_b, col_b, ovf = (t.numpy() for t in outs)
        for f in np.flatnonzero(ovf.any(axis=1)):
            o, c = self.model._redo(self.model._frames(frames[f]), "blocked")
            occ_b[f], col_b[f] = carve_ops.to_host(o), carve_ops.to_host(c)
        return occ_b, col_b

    def __call__(self, frames):
        return self._resolve(self._dispatch(frames))

    def stream(self, batches_iter, depth: int = 2):
        """The sharded step over (F, C, H, W, 3) u8 batches with up to
        ``depth`` batches queued on the device while earlier ones are
        read back and redone where they overflowed (the async dispatch of
        :meth:`VisualHull.stream`).  Yields ``(occ_b, col_b)`` per batch,
        equal to calling the runner on each."""
        q = collections.deque()
        for frames in batches_iter:
            q.append(self._dispatch(frames))
            if len(q) > depth:
                yield self._resolve(q.popleft())
        while q:
            yield self._resolve(q.popleft())


def _ingest(stacked_fz, upload, *, mask_params, use_hsv, ingest,
            roi_offsets):
    """The mask stage's head on an upload in format ``ingest`` → (raw masks
    (C, H, W) u8 with pre-morphology, BGR frames (C, H, W, 3) u8).

    ``"bgr"``: the frames themselves.  ``"yuv420"``: the (C, H·3/2, W) u8
    YUV 4:2:0 pack, unpacked here.  ``"yuv420_roi"``: the pack of (C, RH,
    RW) windows at the host ``roi_offsets`` (C, 2); the frozen model is
    applied to the windows (``background.raw_masks_batched_fz_roi``) and
    the frames are the windows pasted onto zeros."""
    if ingest == "yuv420_roi":
        image_hw = tuple(stacked_fz.bcount.shape[1:3])
        rois = color_ops.yuv420_to_bgr_u8(upload)
        raw = background.raw_masks_batched_fz_roi(
            stacked_fz, rois, roi_offsets, mask_params, use_hsv,
            image_hw=image_hw)
        return raw, background.paste_rois(rois, roi_offsets, image_hw)
    if ingest == "yuv420":
        frames = color_ops.yuv420_to_bgr_u8(upload)
    elif ingest == "bgr":
        frames = upload
    else:
        raise ValueError(f"unknown ingest format {ingest!r}")
    return background.raw_masks_batched_fz(stacked_fz, frames, mask_params,
                                           use_hsv), frames


def _full_step(stacked_fz, frames, btab, *, mask_params, use_hsv,
               fig_thresholds, inner_thresholds, views_threshold, layout,
               ingest="bgr", roi_offsets=None):
    """The per-frame pipeline: (YUV unpack →) HSV → compressed frozen MOG
    apply → pre-morphology → CCL cleanup → post-morphology → blocked carve
    (see :func:`_ingest` for ``ingest`` and ``roi_offsets``).  Returns
    (occ, colors, overflow (C,) bool) in ``layout`` order, or with
    ``layout="packed"`` the viewer wire (``carve_blocked.encode_wire``
    of the blocked outputs, its overflow word set by a component-table or
    a wire overflow)."""
    with span("masks"):
        raw, frames = _ingest(stacked_fz, frames, mask_params=mask_params,
                              use_hsv=use_hsv, ingest=ingest,
                              roi_offsets=roi_offsets)
    with span("cleanup"):
        cleaned, ovf = ccl.clean_masks_batched(raw, fig_thresholds,
                                               inner_thresholds)
    with span("finalize"):
        masks = background.finalize_masks_batched(cleaned, mask_params)
    with span("carve"):
        occ, col = carve_blocked.carve_blocked(
            masks, frames[btab.color_camera], btab,
            views_threshold=views_threshold,
            layout="blocked" if layout == "packed" else layout,
        )
    if layout == "packed":
        packed_k, ids, n_blocks, n_vox, cols, bovf = (
            carve_blocked.pack_blocked_outputs(occ, col))
        return carve_blocked.encode_wire(packed_k, ids, n_blocks, n_vox,
                                         cols, ovf.any() | bovf)
    return occ, col, ovf


def _full_step_tables(stacked_fz, frames, tables, *, mask_params, use_hsv,
                      fig_thresholds, inner_thresholds, views_threshold,
                      color_camera, ingest="bgr", roi_offsets=None):
    """The per-frame pipeline on the table path: the mask stages of
    :func:`_full_step` (the same ``ingest`` formats), then the f64 table
    carve.  Returns (occ (N,) bool, colors (N, 3) u8, overflow (C,) bool),
    canonical order."""
    with span("masks"):
        raw, frames = _ingest(stacked_fz, frames, mask_params=mask_params,
                              use_hsv=use_hsv, ingest=ingest,
                              roi_offsets=roi_offsets)
    with span("cleanup"):
        cleaned, ovf = ccl.clean_masks_batched(raw, fig_thresholds,
                                               inner_thresholds)
    with span("finalize"):
        masks = background.finalize_masks_batched(cleaned, mask_params)
    with span("carve"):
        occ, col = carve_ops.carve_from_tables(
            masks, frames, tables.valid, tables.lin_idx,
            views_threshold=views_threshold, color_camera=color_camera)
    return occ, col, ovf


def _full_step_frames(stacked_fz, frames, btab, *, mask_params, use_hsv,
                      fig_thresholds, inner_thresholds, views_threshold):
    """The multi-frame pipeline on (NF, C, H, W, 3) u8 frames: the mask
    stages over every (frame, camera) image (one cleanup, so one launch of
    kernel K2, for all NF·C images), then the chunk's carve (kernel K4).
    Returns (occ (NF, N) bool canonical, overflow (NF, C) bool)."""
    NF, C, H, W = frames.shape[:4]
    with span("masks"):
        raw = torch.stack([
            background.raw_masks_batched_fz(stacked_fz, fr, mask_params,
                                            use_hsv)
            for fr in frames])
    with span("cleanup"):
        cleaned, ovf = ccl.clean_masks_batched(
            raw.reshape(NF * C, H, W), fig_thresholds * NF,
            inner_thresholds * NF)
    with span("finalize"):
        masks = torch.stack([
            background.finalize_masks_batched(m, mask_params)
            for m in cleaned.reshape(NF, C, H, W)])
    with span("carve"):
        occ = carve_blocked._carve_frames_device(
            masks, btab, views_threshold=views_threshold)
    return occ, ovf.reshape(NF, C)


def _encode_surface_wire(occ, ovf, grid_shape, capacity):
    """One u8 buffer ``[any_ovf i32][n_active i32][idx i32·cap][cfg u8·cap]
    [occ bits]`` (integers little-endian, occupancy bits little-endian
    within each byte, as ``np.packbits(..., bitorder="little")``), so one
    download carries a frame."""
    idx, cfg, n_active = mc.surface_wire_program(occ.reshape(grid_shape),
                                                 capacity=capacity)
    bits = occ.reshape(-1).to(torch.uint8)
    pad = (-bits.numel()) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    occ_packed = (bits.reshape(-1, 8) << shifts).sum(1, dtype=torch.uint8)
    head = torch.stack([ovf.any().to(torch.int32),
                        n_active.to(torch.int32)]).view(torch.uint8)
    return torch.cat([head, idx.to(torch.int32).view(torch.uint8), cfg,
                      occ_packed])


def _decode_surface_wire(wire_host, capacity, num_voxels):
    """Host inverse of :func:`_encode_surface_wire` → (any_ovf, n_active,
    idx (cap,) i32, cfg (cap,) u8, occ (N,) bool) numpy."""
    buf = carve_ops.to_host(wire_host)
    any_ovf, n_active = np.frombuffer(buf[:8].tobytes(), np.int32)
    o = 8
    idx = np.frombuffer(buf[o:o + 4 * capacity].tobytes(), np.int32)
    o += 4 * capacity
    cfg = buf[o:o + capacity]
    o += capacity
    occ = np.unpackbits(buf[o:], bitorder="little",
                        count=num_voxels).astype(bool)
    return int(any_ovf), int(n_active), idx, cfg, occ


def _start_download(tensors):
    """Queue copies of device tensors into pinned host memory → (host
    tensors, CUDA event recorded after the copies); CPU tensors pass
    through with no event."""
    if tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ready = torch.cuda.Event()
    ready.record()
    return tuple(host), ready


def _wait(ready):
    """Block until the downloads of :func:`_start_download` have landed."""
    if ready is not None:
        ready.synchronize()
