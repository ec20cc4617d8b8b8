"""Sharded marching cubes: halo exchange + on-shard triangle emission.

Counterpart of ``vbr_tpu/parallel/mesh_sharded.py``.  A volume sharded
along x needs each shard to see one extra voxel plane from its +x
neighbour (cells straddle the shard boundary); the plane moves around a
ring of ``batch_isend_irecv`` (JAX's ``ppermute``).  Each rank, on its
own slab:

  1. active-cell sweep on the slab + halo (``active_cells_mask``),
  2. fixed-capacity ascending compaction of the active cells
     (``marching_cubes._compact_active``),
  3. triangle emission into a fixed-capacity buffer,
  4. its active-cell count, summed over the axis (JAX's ``psum``).

Shard s owns cells with global x in [s·local_nx, (s+1)·local_nx), in
ascending local flat order, and the buffers are gathered in shard order:
the triangle soup is bit-identical to ``marching_cubes.extract_mesh``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vbr_tpu_torch.ops import marching_cubes as mc
from vbr_tpu_torch.parallel.carve_sharded import (all_gather_dim, axis_size,
                                                  local_block, rank_device)


def _halo(vol: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The first x-plane of the +1 neighbour's slab (ring order).  A ring
    of one is its own neighbour: its plane is taken directly, as JAX's
    ``ppermute`` over one device does (a send to oneself may hang)."""
    n = axis_size(mesh, axis)
    first = vol[0:1].contiguous()
    if n == 1:
        return first
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    i = mesh.get_local_rank(axis)
    halo = torch.empty_like(first)
    ops = [dist.P2POp(dist.isend, first, ranks[(i - 1) % n], group),
           dist.P2POp(dist.irecv, halo, ranks[(i + 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return halo


def _local_active(vol: torch.Tensor, mesh: DeviceMesh, axis: str):
    """Shard-local active cells on the slab + halo → (act (local_nx, ny-1,
    nz-1) bool, ext (local_nx+1, ny, nz)); the last shard's halo wrapped
    around from shard 0 and its cells are masked out."""
    ext = torch.cat([vol, _halo(vol, mesh, axis)], dim=0)
    act = mc.active_cells_mask(ext)
    if mesh.get_local_rank(axis) == axis_size(mesh, axis) - 1:
        act[-1] = False
    return act, ext


def sharded_active_cells(mesh: DeviceMesh, axis: str = "grid"):
    """The sharded active-cell pass: ``fn(local slab (local_nx, ny, nz))``
    → this rank's (local_nx, ny-1, nz-1) bool active cells (the last
    shard's last plane False, keeping the shapes equal)."""

    def fn(vol):
        return _local_active(vol, mesh, axis)[0]

    return fn


def sharded_mesh_extractor(mesh: DeviceMesh, axis: str = "grid",
                           capacity: int = 16384,
                           algorithm: str = "tetrahedra",
                           ambiguity: str = "separate",
                           emit: str = "table"):
    """The sharded extraction: ``fn(local slab)`` →

        (verts (n_shards·capacity·tpc, 3, 3) f32 voxel coords,
         valid (n_shards·capacity·tpc,) bool,
         counts (n_shards,) i32 active cells per shard,
         total (1,) i32 summed over the axis)   on every rank.

    ``capacity`` is the PER-SHARD active-cell capacity; ``algorithm`` is
    "tetrahedra" (12 triangle slots per cell) or "cubes" (the classic 256
    cases).  Slots past a shard's count are invalid; a shard whose count
    exceeds ``capacity`` has truncated output (the counts show it).
    ``emit="table"`` emits from the generated 256-entry table
    (``mc.table_emitter``, bit-identical to the per-cell emitters on BINARY
    volumes); ``"device"`` runs the per-cell emitters."""
    if algorithm == "tetrahedra":
        emit_fn, tpc = mc._emit_triangles, 12
    elif algorithm == "cubes":
        emit_fn = functools.partial(mc._emit_triangles_mc,
                                    ambiguity=ambiguity)
        tpc = mc._mc_maxt(ambiguity)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if emit == "table":
        emit_fn = mc.table_emitter(algorithm, ambiguity, 0.5)
    elif emit != "device":
        raise ValueError(f"unknown emit strategy {emit!r}")

    def fn(vol):
        act, ext = _local_active(vol, mesh, axis)
        flat = act.reshape(-1)
        count = flat.sum(dtype=torch.int32)
        # block_capacity = min(nblk, capacity) makes a block overflow imply
        # count > capacity, so the retry below stays exact
        nblk = -(-flat.shape[0] // mc._COMPACT_BLOCK)
        cell_idx, _ = mc._compact_active(flat, capacity, min(nblk, capacity))
        verts, valid = emit_fn(ext, cell_idx, capacity=capacity)
        slot = torch.arange(capacity * tpc, device=vol.device) // tpc
        valid = valid & (slot < count)
        # local → global x
        verts[:, :, 0] += float(mesh.get_local_rank(axis) * vol.shape[0])
        total = count.reshape(1).clone()
        dist.all_reduce(total, group=mesh.get_group(axis))
        verts, valid, counts = (
            all_gather_dim(x, mesh, axis)
            for x in (verts, valid.to(torch.uint8), count.reshape(1)))
        return verts, valid.bool(), counts, total

    return fn


def extract_mesh_sharded(volume, mesh: DeviceMesh, axis: str = "grid",
                         origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
                         capacity: int = 16384,
                         algorithm: str = "tetrahedra",
                         ambiguity: str = "separate", emit: str = "auto"):
    """Surface of an (nx, ny, nz) volume (numpy or tensor, the whole volume
    on every rank) extracted over the mesh axis ``axis``, each rank on its
    x-slab on its device.  Returns (tris (T, 3, 3) float32 numpy, count),
    bit-identical to ``marching_cubes.extract_mesh`` of the whole volume;
    where ``axis`` does not divide nx, it is ``extract_mesh`` on this
    rank's device.

    ``capacity`` is the first per-shard active-cell capacity; while a
    shard reports more, the program runs again at the next power of two.
    ``emit="auto"`` emits from the table for a bool volume and with the
    per-cell emitters otherwise (a scalar field needs their
    interpolation)."""
    if algorithm not in ("tetrahedra", "cubes"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    mc._ensure_tiling(ambiguity)
    if algorithm == "tetrahedra" and ambiguity != "separate":
        raise ValueError(
            "ambiguity is only supported with algorithm='cubes' (the "
            "6-tet decomposition has no ambiguous faces)"
        )
    if emit not in ("auto", "device"):
        raise ValueError(f"unknown emit strategy {emit!r}")
    is_binary = (volume.dtype == torch.bool if isinstance(volume, torch.Tensor)
                 else np.dtype(volume.dtype) == np.bool_)
    resolved = "table" if (emit == "auto" and is_binary) else "device"
    dev = rank_device(mesh)
    if volume.shape[0] % axis_size(mesh, axis):
        return mc.extract_mesh(volume, origin, spacing, capacity,
                               algorithm=algorithm, ambiguity=ambiguity,
                               emit=emit, device=dev)
    vol = local_block(volume, mesh, (axis,), dev)
    tpc = 12 if algorithm == "tetrahedra" else mc._mc_maxt(ambiguity)
    cap = capacity
    while True:
        fn = sharded_mesh_extractor(mesh, axis, cap, algorithm, ambiguity,
                                    resolved)
        verts, valid, counts, total = fn(vol)
        worst = int(counts.max())
        if worst <= cap:
            break
        cap = 1 << int(np.ceil(np.log2(worst)))
    tris = verts[valid].cpu().numpy()
    if len(tris) > tpc * int(total[0]):
        raise RuntimeError("more triangles than the active cells can emit")
    tris = tris * np.asarray(spacing, np.float32) + np.asarray(
        origin, np.float32)
    return tris.astype(np.float32), len(tris)
