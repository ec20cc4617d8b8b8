"""Background training and the batched mask stage of the per-frame step
(all cameras at once).

Counterpart of ``vbr_tpu/pipelines/background.py``:
``train_background_model`` (MOG training over a background sequence),
``stack_states``, ``stack_frozen``
(per-camera states → one prefix-compressed stacked state),
``raw_masks_batched_fz`` (HSV + compressed frozen apply + per-camera
pre-morphology), its ROI form ``raw_masks_batched_fz_roi`` with
``paste_rois`` (the windowed reduced-byte ingest),
``finalize_masks_batched`` (per-camera post-morphology + binarize),
``raw_masks_batched`` (the same head on the uncompressed states),
``extract_foreground_mask`` (one camera's whole mask stage, with its three
cleanup routes) and ``BackgroundPipeline`` (per-camera models from npz
files, background frames or the rig's ``background.avi``, and their
masks).

``MaskStage`` is the one home of the step paths' mask stage (head →
cleanup → finalize, under their spans): the live and offline steps, the
table step, ``VisualHull.masks``, ``validate_reduced_ingest`` and the
sharded step all call it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from vbr_tpu_torch.ops import ccl, gmm, morphology
from vbr_tpu_torch.ops import color as color_ops
from vbr_tpu_torch.utils import profiling
from vbr_tpu_torch.utils.config import (DEFAULT_MASK_PARAMS, MaskParams,
                                        MOGParams)
from vbr_tpu_torch.utils.device import resolve_device
from vbr_tpu_torch.utils.profiling import span


def train_background_model(background_frames: np.ndarray,
                           params: MOGParams = MOGParams(),
                           device="cuda") -> gmm.MOGState:
    """Train the production MOG model (HSV, learning rate 1/min(n,
    history)) over (T, H, W, 3) u8 BGR frames on ``device``."""
    return gmm.train_mog(background_frames, params, device=device)


def extract_foreground_mask(
    state: gmm.MOGState,
    frame,  # (H, W, 3) u8 BGR, numpy or torch
    mask_params: MaskParams = MaskParams(),
    mog_params: MOGParams = MOGParams(),
    ccl_backend: str = "device",
) -> torch.Tensor:
    """One camera's mask stage → (H, W) u8 {0, 255} on the state's device:

      BGR→HSV → frozen MOG apply → optional pre open/close (3×3) →
      contour-hierarchy cleanup → optional post open/close (2×2) → binarize.

    ``ccl_backend`` picks the cleanup, all three with the same result:
    ``"device"`` (default) labels with kernel K2 (``ccl.clean_masks_batched``)
    and redoes the image exactly on the host when it overflows a component
    table; ``"host"`` is ``ccl.clean_mask_host`` on scipy; ``"device-xla"``
    is ``ccl.clean_mask`` in plain torch ops on the device."""
    if ccl_backend not in ("device", "host", "device-xla"):
        raise ValueError(f"unknown ccl_backend {ccl_backend!r}")
    raw = gmm.extract_mask(state, frame, mog_params)
    if mask_params.opening_pre:
        raw = morphology.opening(raw, (3, 3))
    if mask_params.closing_pre:
        raw = morphology.closing(raw, (3, 3))

    def host():
        return torch.from_numpy(ccl.clean_mask_host(
            raw.cpu().numpy(), mask_params.figure_threshold,
            mask_params.inner_threshold)).to(raw.device)

    if ccl_backend == "host":
        cleaned = host()
    elif ccl_backend == "device-xla":
        cleaned = ccl.clean_mask(raw, mask_params.figure_threshold,
                                 mask_params.inner_threshold)
    else:
        batch, ovf = ccl.clean_masks_batched(
            raw[None], (float(mask_params.figure_threshold),),
            (float(mask_params.inner_threshold),))
        cleaned = host() if bool(ovf[0]) else batch[0]  # exact redo
    return finalize_masks_batched(cleaned[None], (mask_params,))[0]


class BackgroundPipeline:
    """Per-camera background models and per-frame mask extraction (the
    reference's ``set_voxel_positions`` initialization: one model per
    camera, history = its frame count).

    Camera c's model (1-based file names) is ``cache_dir/mog_cam{c}.npz``
    where that file exists (schema 2, as either package writes it), else
    trained on ``device`` from ``background_frames[c - 1]`` ((T, H, W, 3)
    u8 BGR) when given, else from ``data_dir/cam{c}/background.avi``, and
    then written to the cache when ``cache_dir`` is given.  Without
    ``data_dir`` a camera with neither model nor frames raises
    ``ValueError``."""

    def __init__(
        self,
        data_dir: Optional[str] = None,
        num_cameras: int = 4,
        mask_params: Sequence[MaskParams] = DEFAULT_MASK_PARAMS,
        mog_params: Optional[MOGParams] = None,
        cache_dir: Optional[str] = None,
        background_frames=None,
        device="cuda",
    ):
        from vbr_tpu_torch.utils import artifacts
        from vbr_tpu_torch.utils import video as vio

        dev = resolve_device(device)
        self.mask_params = list(mask_params)
        self.states: List[gmm.MOGState] = []
        self.mog_params: List[MOGParams] = []
        for cam in range(1, num_cameras + 1):
            cache_path = (os.path.join(cache_dir, f"mog_cam{cam}.npz")
                          if cache_dir else None)
            state = (artifacts.load_mog_state(cache_path, device=dev)
                     if cache_path else None)
            if state is not None:
                p = mog_params or MOGParams(history=int(state.nframes))
            else:
                if background_frames is not None:
                    frames = background_frames[cam - 1]
                elif data_dir is not None:
                    frames = vio.read_video(os.path.join(
                        data_dir, f"cam{cam}", "background.avi"))
                else:
                    raise ValueError(
                        f"camera {cam}: no background model "
                        f"({cache_path or 'no cache_dir'}), no "
                        "background_frames and no data_dir; pass cache_dir= "
                        "with mog_cam{c}.npz files, background_frames= or "
                        "a data_dir with cam{c}/background.avi")
                p = mog_params or MOGParams(history=frames.shape[0])
                state = train_background_model(frames, p, device=dev)
                if cache_path:
                    artifacts.save_mog_state(cache_path, state)
            self.states.append(state)
            self.mog_params.append(p)

    def masks_for_frames(self, frames,
                         ccl_backend: str = "host") -> np.ndarray:
        """(C, H, W, 3) u8 BGR → (C, H, W) u8 {0, 255} cleaned masks."""
        return np.stack([
            extract_foreground_mask(self.states[c], frame,
                                    self.mask_params[c], self.mog_params[c],
                                    ccl_backend=ccl_backend).cpu().numpy()
            for c, frame in enumerate(frames)])


def raw_masks_batched(stacked: gmm.MOGState, frames: torch.Tensor,
                      mask_params: Sequence,
                      mog_params: MOGParams) -> torch.Tensor:
    """(C, H, W, 3) u8 BGR → (C, H, W) u8 raw masks with pre-morphology,
    each camera's frozen apply on its uncompressed state of the stacked
    (leading camera axis) ``stacked``."""
    x = color_ops.bgr_to_hsv_u8(frames) if mog_params.use_hsv else frames
    raw = torch.stack([
        gmm.apply_frozen(gmm.MOGState(weight=stacked.weight[c],
                                      mean=stacked.mean[c],
                                      var=stacked.var[c],
                                      nframes=stacked.nframes[c]),
                         x[c], mog_params)
        for c in range(frames.shape[0])])
    return _pre_morphology(raw, mask_params)


def stack_states(states: Sequence[gmm.MOGState]) -> gmm.MOGState:
    """Stack per-camera MOG states along a leading camera axis."""
    return gmm.MOGState(
        weight=torch.stack([s.weight for s in states]),
        mean=torch.stack([s.mean for s in states]),
        var=torch.stack([s.var for s in states]),
        nframes=torch.stack([s.nframes for s in states]),
    )


def stack_frozen(states: Sequence[gmm.MOGState], params: MOGParams,
                 device="cuda") -> gmm.FrozenMOGState:
    """Per-camera MOG states → one (C, H, W, Ke) compressed state on
    ``device``; all cameras share the largest prefix length."""
    device = resolve_device(device)
    K = states[0].weight.shape[-1]
    fulls = [gmm.compress_frozen(s, params, k_eff=K)[0] for s in states]
    k_eff = max(max((int(f.bcount.max()) for f in fulls), default=1), 1)
    return gmm.FrozenMOGState(
        mean=torch.stack([f.mean[..., :k_eff, :] for f in fulls]).to(device),
        thr=torch.stack([f.thr[..., :k_eff] for f in fulls]).to(device),
        bcount=torch.stack([f.bcount for f in fulls]).to(device),
    )


def raw_masks_batched_fz(fz: gmm.FrozenMOGState, frames: torch.Tensor,
                         mask_params: Sequence, use_hsv: bool = True):
    """(C, H, W, 3) u8 BGR → (C, H, W) u8 raw masks with pre-morphology."""
    x = color_ops.bgr_to_hsv_u8(frames) if use_hsv else frames
    return _pre_morphology(gmm.apply_frozen_compressed(fz, x), mask_params)


def _pre_morphology(raw: torch.Tensor, mask_params: Sequence):
    """Each camera's optional 3×3 opening and closing of (C, H, W) raw
    masks."""
    out = []
    for c in range(raw.shape[0]):
        m, mp = raw[c], mask_params[c]
        if mp.opening_pre:
            m = morphology.opening(m, (3, 3))
        if mp.closing_pre:
            m = morphology.closing(m, (3, 3))
        out.append(m)
    return torch.stack(out)


def _window_origin(offset, size, image_hw):
    """A window's (y0, x0) as Python ints, read as
    ``jax.lax.dynamic_slice`` and ``dynamic_update_slice`` read their start
    indices: a negative one counts from the end of its axis, then each is
    clamped so that the window fits the image."""
    return tuple(min(max(int(o) + (n if int(o) < 0 else 0), 0), n - s)
                 for o, s, n in zip(offset, size, image_hw))


def raw_masks_batched_fz_roi(fz: gmm.FrozenMOGState, rois: torch.Tensor,
                             offsets, mask_params: Sequence,
                             use_hsv: bool = True, *, image_hw):
    """ROI form of :func:`raw_masks_batched_fz`: (C, RH, RW, 3) u8 BGR
    windows at the host ``offsets`` (C, 2) ints [y0, x0] → (C, H, W) u8 raw
    masks.  The frozen model is applied to each camera's state cut at its
    window, the window's raw mask is pasted onto a zero (background) canvas,
    and the pre-morphology runs on the whole frame; so where the window
    holds every foreground pixel, the masks equal the full-frame stage's.
    The offsets stay on the host (the tracker's numpy values): slicing with
    them needs no device read."""
    H, W = image_hw
    C, RH, RW = rois.shape[:3]
    x = color_ops.bgr_to_hsv_u8(rois) if use_hsv else rois
    org = [_window_origin(offsets[c], (RH, RW), image_hw) for c in range(C)]
    crop = gmm.FrozenMOGState(*(
        torch.stack([a[c, y0:y0 + RH, x0:x0 + RW]
                     for c, (y0, x0) in enumerate(org)])
        for a in (fz.mean, fz.thr, fz.bcount)))
    raw_roi = gmm.apply_frozen_compressed(crop, x)
    raw = raw_roi.new_zeros((C, H, W))
    for c, (y0, x0) in enumerate(org):
        raw[c, y0:y0 + RH, x0:x0 + RW] = raw_roi[c]
    return _pre_morphology(raw, mask_params)


def paste_rois(rois: torch.Tensor, offsets, image_hw) -> torch.Tensor:
    """(C, RH, RW, 3) windows + host (C, 2) origins → (C, H, W, 3) frames,
    zero outside the windows: the colour frames of the ROI ingest."""
    C, RH, RW = rois.shape[:3]
    out = rois.new_zeros((C, *image_hw, rois.shape[-1]))
    for c in range(C):
        y0, x0 = _window_origin(offsets[c], (RH, RW), image_hw)
        out[c, y0:y0 + RH, x0:x0 + RW] = rois[c]
    return out


def finalize_masks_batched(cleaned: torch.Tensor,
                           mask_params: Sequence) -> torch.Tensor:
    """(C, H, W) u8 cleaned masks → post-morphology, binarized {0, 255}."""
    out = []
    for c in range(cleaned.shape[0]):
        m, mp = cleaned[c], mask_params[c]
        if mp.opening_post:
            m = morphology.opening(m, (2, 2))
        if mp.closing_post:
            m = morphology.closing(m, (2, 2))
        out.append(torch.where(m > 0, 255, 0).to(torch.uint8))
    return torch.stack(out)


@dataclasses.dataclass(frozen=True)
class MaskStage:
    """The mask stage of every step path, in one place: an upload →
    (cleaned masks (C, H, W) u8 {0, 255}, overflow (C,) bool, BGR frames
    (C, H, W, 3) u8).  Its parts run in order, each under its recorder
    span (``utils.profiling``):

      masks     :meth:`head` — (YUV unpack →) HSV → compressed frozen MOG
                apply → per-camera pre-morphology
      cleanup   :meth:`cleanup` — kernel K2 (``ccl.clean_masks_batched``)
      finalize  :meth:`finalize` — per-camera post-morphology, binarized

    Every method also takes a leading frame axis (NF, ...): the head and
    the finalize run once per frame, the cleanup once for all NF·C images;
    the outputs keep the axis.  ``ovf[..., c]`` marks a camera whose
    cleanup overflowed a component table: its mask is truncated, and
    :meth:`exact` redoes it on the host."""

    fz: gmm.FrozenMOGState  # (C, H, W, Ke) compressed frozen models
    mask_params: tuple  # per-camera MaskParams (the morphology flags)
    use_hsv: bool
    fig_thresholds: tuple  # per-camera floats of the cleanup
    inner_thresholds: tuple

    @classmethod
    def build(cls, states, mog_params, mask_params, device) -> "MaskStage":
        """The stage of per-camera MOG ``states`` trained with
        ``mog_params``, compressed and stacked on ``device``.  The batched
        apply needs the same apply parameters on every camera
        (``ValueError`` otherwise)."""
        p0 = mog_params[0]
        fields = ("bg_ratio", "use_hsv", "match_sigma")
        for p in mog_params[1:]:
            if any(getattr(p, f) != getattr(p0, f) for f in fields):
                raise ValueError(
                    "the batched mask stage needs uniform MOG apply "
                    "params (bg_ratio, use_hsv, match_sigma) across "
                    f"cameras; got {[(q.bg_ratio, q.use_hsv, q.match_sigma) for q in mog_params]}"
                )
        return cls(stack_frozen(states, p0, device), tuple(mask_params),
                   p0.use_hsv,
                   tuple(float(p.figure_threshold) for p in mask_params),
                   tuple(float(p.inner_threshold) for p in mask_params))

    def head(self, frames, ingest="bgr", roi_offsets=None):
        """The stage's head on an upload in format ``ingest`` → (raw masks
        (C, H, W) u8 with pre-morphology, BGR frames (C, H, W, 3) u8).

        ``"bgr"``: the frames themselves.  ``"yuv420"``: the (C, H·3/2, W)
        u8 YUV 4:2:0 pack, unpacked here.  ``"yuv420_roi"``: the pack of
        (C, RH, RW) windows at the host ``roi_offsets`` (C, 2); the frozen
        model is applied to the windows (:func:`raw_masks_batched_fz_roi`)
        and the frames are the windows pasted onto zeros.  With a leading
        frame axis, ``roi_offsets`` has one too."""
        if ingest not in ("bgr", "yuv420", "yuv420_roi"):
            raise ValueError(f"unknown ingest format {ingest!r}")
        if frames.dim() == (5 if ingest == "bgr" else 4):  # frame axis
            outs = [self.head(fr, ingest, None if roi_offsets is None
                              else roi_offsets[i])
                    for i, fr in enumerate(frames)]
            return (torch.stack([raw for raw, _ in outs]),
                    frames if ingest == "bgr"
                    else torch.stack([bgr for _, bgr in outs]))
        if ingest == "yuv420_roi":
            image_hw = tuple(self.fz.bcount.shape[1:3])
            rois = color_ops.yuv420_to_bgr_u8(frames)
            raw = raw_masks_batched_fz_roi(
                self.fz, rois, roi_offsets, self.mask_params, self.use_hsv,
                image_hw=image_hw)
            return raw, paste_rois(rois, roi_offsets, image_hw)
        if ingest == "yuv420":
            frames = color_ops.yuv420_to_bgr_u8(frames)
        return raw_masks_batched_fz(self.fz, frames, self.mask_params,
                                    self.use_hsv), frames

    def cleanup(self, raw):
        """(C, H, W) or (NF, C, H, W) raw masks → (cleaned, overflow (C,)
        or (NF, C) bool): one launch of kernel K2 over every image."""
        if raw.dim() == 3:  # no reshapes: no host ops on the live step
            return ccl.clean_masks_batched(raw, self.fig_thresholds,
                                           self.inner_thresholds)
        NF = raw.shape[0]
        cleaned, ovf = ccl.clean_masks_batched(
            raw.flatten(0, 1), self.fig_thresholds * NF,
            self.inner_thresholds * NF)
        return cleaned.reshape(raw.shape), ovf.reshape(raw.shape[:2])

    def finalize(self, cleaned):
        """(C, H, W) or (NF, C, H, W) cleaned masks → post-morphology,
        binarized, one :func:`finalize_masks_batched` per frame."""
        if cleaned.dim() == 3:
            return finalize_masks_batched(cleaned, self.mask_params)
        return torch.stack([finalize_masks_batched(m, self.mask_params)
                            for m in cleaned])

    def _staged(self, frames, ingest, roi_offsets):
        """The three parts under their spans → (raw, masks, ovf, bgr)."""
        with span("masks"):
            raw, bgr = self.head(frames, ingest, roi_offsets)
        with span("cleanup"):
            cleaned, ovf = self.cleanup(raw)
        with span("finalize"):
            masks = self.finalize(cleaned)
        return raw, masks, ovf, bgr

    def __call__(self, frames, ingest="bgr", roi_offsets=None):
        """The whole stage on an upload (see :meth:`head`) → (masks, ovf,
        bgr)."""
        return self._staged(frames, ingest, roi_offsets)[1:]

    def exact(self, frames) -> torch.Tensor:
        """(C, H, W, 3) u8 BGR frames → the stage's masks with each camera
        whose cleanup overflowed redone by the host cleanup
        (``ccl.clean_mask_host``, counted as ``host_cleanups``)."""
        raw, masks, ovf, _ = self._staged(frames, "bgr", None)
        ovf = ovf.cpu().numpy()
        if ovf.any():
            raw_h = raw.cpu().numpy()
            for c in np.flatnonzero(ovf):
                profiling.count("host_cleanups")
                cleaned_c = ccl.clean_mask_host(
                    raw_h[c], self.fig_thresholds[c],
                    self.inner_thresholds[c])
                masks[c] = finalize_masks_batched(
                    torch.from_numpy(cleaned_c)[None].to(masks.device),
                    (self.mask_params[c],))[0]
        return masks
