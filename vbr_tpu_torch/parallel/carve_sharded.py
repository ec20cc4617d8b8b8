"""The (data, cam, grid) mesh on ``torch.distributed``, and the sharded
gather carve.

Counterpart of ``vbr_tpu/parallel/carve_sharded.py``.  The mesh axes map
the reference's loops (SURVEY.md §2c):

  * ``data`` — the frame batch (the frame loop, assignment.py:94),
  * ``cam``  — the cameras; per-camera view counts are summed over this
    axis (the camera loop and the ≥4-views rule, assignment.py:119-121),
  * ``grid`` — the voxels (the voxel loop, voxel_reconstruction.py:105-122).

Each rank is one process on one device (see ``vbr_tpu_torch.parallel``).
A mesh needs an initialised default process group:
:func:`init_rank_group` starts one from a ``FileStore`` (NCCL for CUDA,
gloo for the CPU), and ``torchrun`` callers start theirs as usual.  Nothing
falls back to one device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.utils.device import resolve_device

MESH_DIMS = ("data", "cam", "grid")


def init_rank_group(store_path: str, rank: int = 0, world_size: int = 1,
                    device="cuda") -> torch.device:
    """Start the default process group from a ``FileStore`` at
    ``store_path`` (a file that does not exist yet; every rank names the
    same one): NCCL for ``device="cuda"``, gloo for ``"cpu"``.  Returns the
    rank's device, ``cuda:{rank mod device count}`` (made current) or the
    CPU.  With the defaults it is the one-rank group of a single card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {dev}")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    return dev


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh needs an initialised default process group; start one "
            "(init_rank_group, or torchrun + init_process_group) first")


def carve_mesh(shape, device="cuda") -> DeviceMesh:
    """A (data, cam, grid) mesh of ``shape`` over the default process
    group's ranks (rank = (d·cam + c)·grid + g); raises without an
    initialised group."""
    _require_group()
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=MESH_DIMS)


def make_carve_mesh(n_devices: Optional[int] = None, num_cameras: int = 4,
                    frame_batch: int = 1, device="cuda") -> DeviceMesh:
    """A (data, cam, grid) mesh over the default group's world.

    Gives the data axis min(frame_batch, ...) ways and the camera axis
    min(num_cameras, remaining) ways, each the largest divisor of what is
    left; every leftover factor goes to the grid axis (the rule of the JAX
    function).  ``n_devices``, when given, must be the world size: a rank
    outside the mesh would have no program to run."""
    _require_group()
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices {n_devices} != world size {n}")

    def _axis(n_left: int, want: int) -> int:
        w = min(want, n_left)
        while w > 1 and n_left % w != 0:
            w -= 1
        return max(w, 1)

    data = _axis(n, frame_batch)
    cam = _axis(n // data, num_cameras)
    return carve_mesh((data, cam, n // (data * cam)), device)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shard runs on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather_dim(x: torch.Tensor, mesh: DeviceMesh, name: str,
                   dim: int = 0) -> torch.Tensor:
    """The tiled ``all_gather`` of JAX over mesh axis ``name``: every
    shard's ``x`` concatenated along ``dim`` in axis order."""
    n = axis_size(mesh, name)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=mesh.get_group(name))
    return out.movedim(0, dim)


def local_block(x, mesh: DeviceMesh, axes, device):
    """This rank's block of a host (or device) array sharded over mesh
    ``axes``: ``axes[i]`` names the mesh axis that splits dimension i of
    ``x`` (None: not split), as a JAX ``PartitionSpec``; on ``device``."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    for i, name in enumerate(axes):
        if name is None:
            continue
        n = axis_size(mesh, name)
        if x.shape[i] % n:
            raise ValueError(f"dimension {i} ({x.shape[i]}) is not "
                             f"divisible by the {name} axis ({n})")
        k = x.shape[i] // n
        x = x.narrow(i, mesh.get_local_rank(name) * k, k)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.contiguous().pin_memory().to(device, non_blocking=True)
    return x.to(device).contiguous()


def sharded_carve_step(mesh: DeviceMesh, *, views_threshold: int = 4,
                       color_camera: int = 1):
    """The sharded carve step over ``mesh``:

        step(masks (f, c, H, W) u8, images (f, c, H, W, 3) u8,
             valid (c, n) bool, lin_idx (c, n) i32)   this rank's blocks
          -> (occupancy (F, N) bool, colors (F, N, 3) u8)   on every rank

    (see :func:`shard_inputs`).  Each rank counts its cameras' views of its
    voxels (``carve.view_counts``); the counts are summed over the ``cam``
    axis; the colour camera's owner gathers the colours, summed over
    ``cam`` with zeros from the others.  Occupancy and colours are then
    gathered over ``grid`` and ``data``."""

    def step(masks, images, valid, lin_idx):
        f, c = masks.shape[:2]
        count = torch.stack([carve_ops.view_counts(m, valid, lin_idx)
                             for m in masks])  # (f, n) i32
        dist.all_reduce(count, group=mesh.get_group("cam"))
        occupancy = (count >= views_threshold).to(torch.uint8)
        owner, local_idx = divmod(color_camera, c)
        col = torch.stack([
            im[local_idx].reshape(-1, 3)[lin_idx[local_idx].long()]
            for im in images]).to(torch.int32)  # (f, n, 3)
        if mesh.get_local_rank("cam") != owner:
            col.zero_()
        dist.all_reduce(col, group=mesh.get_group("cam"))
        colors = col.to(torch.uint8)
        occupancy, colors = (
            all_gather_dim(all_gather_dim(x, mesh, "grid", 1), mesh, "data")
            for x in (occupancy, colors))
        return occupancy.bool(), colors

    return step


def shard_inputs(mesh: DeviceMesh, masks, images, valid, lin_idx):
    """This rank's blocks of the carve step's host arrays, on its device:
    masks and images split over (data, cam), the tables over (cam,
    grid)."""
    dev = rank_device(mesh)
    return (local_block(masks, mesh, ("data", "cam"), dev),
            local_block(images, mesh, ("data", "cam"), dev),
            local_block(valid, mesh, ("cam", "grid"), dev),
            local_block(lin_idx, mesh, ("cam", "grid"), dev))
