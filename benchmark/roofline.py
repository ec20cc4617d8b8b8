"""The peaks of one NVIDIA H100 SXM and the work each kernel of the step
must do, counted from the inputs alone (the reference's masks and
projections), so that a roofline reads the same work whatever kernel does
it.

A kernel's least time is the larger of its bytes over the HBM bandwidth
and its operations over the float32 rate outside the tensor cores
(NVIDIA's data sheet, at the card's 700 W limit).  Each byte an input
needs is counted once and each output byte once; where the work depends
on the data, what these inputs need is counted, not what a launch plan
reads.  These are the counts of ``chip_smoke.py``'s ``k1_work``,
``k4_work``, ``mask_bytes_read`` and K2's byte count, taken from the
inputs instead of the program's tables.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BLOCK = 8  # the carve's work unit: 8³ voxels
GEOMETRY_BYTES = 4  # one packed projection (row, column) per voxel and camera


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def k2_bytes(num_images: int, image_hw) -> int:
    """The combined-phase labelling of ``num_images`` masks: one byte in
    and a 32-bit label out per pixel, and an iteration count per image."""
    H, W = image_hw
    return num_images * (H * W * (1 + 4) + 4)


def _block_ids(grid) -> torch.Tensor:
    nx, ny, nz = grid["nx"], grid["ny"], grid["nz"]
    ix = torch.arange(nx).div(BLOCK, rounding_mode="floor")
    iy = torch.arange(ny).div(BLOCK, rounding_mode="floor")
    iz = torch.arange(nz).div(BLOCK, rounding_mode="floor")
    by, bz = -(-ny // BLOCK), -(-nz // BLOCK)
    return ((ix[:, None, None] * by + iy[None, :, None]) * bz
            + iz[None, None, :]).reshape(-1)


class Blocks:
    """The grid's 8³ blocks in the canonical voxel order."""

    def __init__(self, grid, device):
        self.ids = _block_ids(grid).to(device)
        self.n = int(self.ids.max()) + 1

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.n, dtype=torch.int32, device=flags.device)
        return out.index_add_(0, self.ids, flags.to(torch.int32)) > 0

    def all(self, flags: torch.Tensor) -> torch.Tensor:
        return ~self.any(~flags)


def classify(proj, blocks, masks, views_threshold):
    """What one frame's (C, H, W) masks need of each 8³ block → (computed,
    full) bool per block.  A block is full where every camera sees
    foreground at every voxel (it is occupied without a look), and computed
    where at least ``views_threshold`` cameras see foreground at one of its
    voxels and it is not full."""
    C = masks.shape[0]
    flat = masks.reshape(C, -1)
    hits = torch.stack([proj.valid[c] & flat[c][proj.lin[c]]
                        for c in range(C)])
    seen = torch.stack([blocks.any(h) for h in hits]).sum(0)
    full = blocks.all(hits.all(0))
    return (seen >= views_threshold) & ~full, full


def _mask_bytes(proj, blocks, computed):
    """Distinct mask pixels the computed blocks' valid projections address,
    summed over the cameras."""
    vox = computed[blocks.ids]
    return sum(int(torch.unique(proj.lin[c][vox & proj.valid[c]]).numel())
               for c in range(proj.lin.shape[0]))


def k1_work(proj, blocks, masks, occ, views_threshold, color_camera,
            flags=None):
    """(bytes, operations) of one frame's carve of (C, H, W) masks into the
    (N,) occupancy ``occ``: the computed blocks' projections and the mask
    bytes they address, the colour camera's projection of each full block,
    the colour pixels of the occupied voxels, and the outputs (occupancy
    and three colour bytes per voxel); a decode, compare and add per view
    of each computed voxel.  ``flags`` = (computed, full) replaces
    :func:`classify`'s."""
    C, N = proj.lin.shape
    computed, full = flags or classify(proj, blocks, masks, views_threshold)
    n_comp, n_full = int(computed.sum()), int(full.sum())
    colour_px = int(torch.unique(proj.lin[color_camera][occ]).numel())
    vox = BLOCK ** 3
    n_bytes = (n_comp * vox * C * GEOMETRY_BYTES
               + n_full * vox * GEOMETRY_BYTES + int(occ.sum()) * 4
               + _mask_bytes(proj, blocks, computed) + 3 * colour_px + 4 * N)
    return n_bytes, n_comp * vox * C * 8


def k4_work(proj, blocks, masks_chunk, views_threshold, flags=None):
    """(bytes, operations) of one chunk's multi-frame carve of (NF, C, H,
    W) masks: a block is computed where some frame needs it and not every
    frame finds it full; its projections are read once, the mask bytes
    they address in every frame, and one occupancy byte per voxel and frame
    is written.  ``flags`` = (computed, full) replaces that
    classification."""
    NF = masks_chunk.shape[0]
    C, N = proj.lin.shape
    if flags is None:
        per = [classify(proj, blocks, m, views_threshold)
               for m in masks_chunk]
        full = torch.stack([f for _, f in per]).all(0)
        need = torch.stack([c | f for c, f in per]).any(0)
        flags = (need & ~full, full)
    computed = flags[0]
    n_comp = int(computed.sum())
    vox = BLOCK ** 3
    n_bytes = (n_comp * vox * C * GEOMETRY_BYTES
               + NF * _mask_bytes(proj, blocks, computed) + NF * N)
    return n_bytes, n_comp * vox * C * (5 + 2 * NF)
