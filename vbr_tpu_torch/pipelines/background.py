"""Background training and the batched mask stages of the per-frame step
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
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from vbr_tpu_torch.ops import ccl, gmm, morphology
from vbr_tpu_torch.ops import color as color_ops
from vbr_tpu_torch.utils.config import (DEFAULT_MASK_PARAMS, MaskParams,
                                        MOGParams)
from vbr_tpu_torch.utils.device import resolve_device


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
