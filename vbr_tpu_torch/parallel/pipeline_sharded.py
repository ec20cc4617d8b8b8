"""Full sharded per-frame step over the (data, cam, grid) mesh.

Counterpart of ``vbr_tpu/parallel/pipeline_sharded.py``: the multi-device
``VisualHull.process_frame`` on the portable ops.  Each rank applies the
frozen MOG models of its cameras to its frames (``gmm.apply_frozen``), a
3×3 opening (and with ``clean=True`` the contour-hierarchy cleanup,
``ccl.clean_mask``), then counts its cameras' views of its voxels; the
counts are summed over the ``cam`` axis (JAX's ``psum``,
pipeline_sharded.py:99) and the occupancy gathered over ``grid`` and
``data``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.ops import ccl as ccl_ops
from vbr_tpu_torch.ops import gmm as gmm_ops
from vbr_tpu_torch.ops import morphology
from vbr_tpu_torch.parallel.carve_sharded import (all_gather_dim,
                                                  local_block, rank_device)
from vbr_tpu_torch.utils.config import MOGParams


def sharded_pipeline_step(mesh: DeviceMesh, *, views_threshold: int = 4,
                          mog_params: MOGParams = MOGParams(),
                          clean: bool = False):
    """The sharded step:

        step(frames_hsv (f, c, H, W, 3) u8,
             weight (c, H, W, K), mean (c, H, W, K, 3), var (c, H, W, K),
             valid (c, n) bool, lin_idx (c, n) i32
             [, fig_thr (c,), inner_thr (c,)  when clean=True])
          -> occupancy (F, N) bool   on every rank

    with this rank's blocks of :func:`place_pipeline_inputs`.  The apply is
    the production ``gmm.apply_frozen`` with every gate parameter from
    ``mog_params``; the masks stay on their rank from the apply to the
    carve."""

    def step(frames, weight, mean, var, valid, lin_idx, fig_thr=None,
             inner_thr=None):
        f, c = frames.shape[:2]
        count = []
        for fr in frames:
            masks = []
            for k in range(c):
                state = gmm_ops.MOGState(
                    weight=weight[k], mean=mean[k], var=var[k],
                    nframes=torch.zeros((), dtype=torch.int32))
                raw = gmm_ops.apply_frozen(state, fr[k], mog_params)
                m = morphology.opening(raw, (3, 3))
                if clean:
                    m = ccl_ops.clean_mask(m, float(fig_thr[k]),
                                           float(inner_thr[k]))
                masks.append(m)
            count.append(carve_ops.view_counts(torch.stack(masks), valid,
                                               lin_idx))
        count = torch.stack(count)  # (f, n) i32
        dist.all_reduce(count, group=mesh.get_group("cam"))
        occ = (count >= views_threshold).to(torch.uint8)
        occ = all_gather_dim(all_gather_dim(occ, mesh, "grid", 1), mesh,
                             "data")
        return occ.bool()

    return step


def place_pipeline_inputs(mesh: DeviceMesh, frames_hsv, weight, mean, var,
                          valid, lin_idx, fig_thr=None, inner_thr=None):
    """This rank's blocks of the step's host arrays, on its device: frames
    over (data, cam), the MOG state and thresholds over cam, the tables
    over (cam, grid).  The thresholds stay f32 values on the host."""
    dev = rank_device(mesh)
    out = (
        local_block(frames_hsv, mesh, ("data", "cam"), dev),
        local_block(weight, mesh, ("cam",), dev),
        local_block(mean, mesh, ("cam",), dev),
        local_block(var, mesh, ("cam",), dev),
        local_block(valid, mesh, ("cam", "grid"), dev),
        local_block(lin_idx, mesh, ("cam", "grid"), dev),
    )
    if fig_thr is not None:
        cpu = torch.device("cpu")
        out += tuple(
            local_block(torch.tensor(t, dtype=torch.float32), mesh,
                        ("cam",), cpu).tolist()
            for t in (fig_thr, inner_thr))
    return out
