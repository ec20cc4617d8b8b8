"""On-disk artifacts in the JAX package's formats: projection-table
caches and background-model checkpoints.

Counterpart of ``vbr_tpu/utils/artifacts.py``:

  * ``save_projection_tables`` / ``load_projection_tables`` /
    ``cached_projection_tables`` — the f64 carve tables as npz, keyed by
    ``_config_key`` (a hash of the cameras, the grid and the image size),
    with the same keys and layout, so a cache written by either package
    loads in the other; the key depends on the field order of the port's
    ``CameraParams`` and ``GridConfig`` copies, which is the JAX package's;
  * ``save_mog_state`` / ``load_mog_state`` — npz schema 2 (weight, mean,
    var, nframes, schema=2), so a model trained and saved by ``vbr_tpu``
    loads into the port and back.

``from_numpy_state`` takes such a state as numpy arrays directly, and
``train_state_from_numpy`` / ``train_state_to_numpy`` carry a mid-training
``MOGTrainState`` across, so both packages can go on from the same state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.ops.gmm import (MOGState, MOGTrainState,
                                   slot_high_water)
from vbr_tpu_torch.utils.config import CameraParams, GridConfig
from vbr_tpu_torch.utils.device import resolve_device


def _config_key(cameras: Sequence[CameraParams], grid: GridConfig,
                image_hw, extra: str = "") -> str:
    """16 hex digits of the SHA-1 of the configuration's JSON: the same
    string as the JAX package's for the same cameras, grid and image."""
    payload = json.dumps(
        {
            "cams": [dataclasses.astuple(c) for c in cameras],
            "grid": dataclasses.astuple(grid),
            "hw": list(image_hw),
            "extra": extra,
        },
        sort_keys=True,
    )
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def save_projection_tables(path: str, tables: carve_ops.ProjectionTables,
                           key: str = ""):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        valid=tables.valid.cpu().numpy(),
        lin_idx=tables.lin_idx.cpu().numpy(),
        image_hw=np.asarray(tables.image_hw),
        key=np.asarray(key),
    )


def load_projection_tables(path: str, key: str = "",
                           device="cuda") -> Optional[carve_ops.ProjectionTables]:
    """The cached tables on ``device`` (raises where that is a missing
    card), or None when the file is missing or was written for another
    configuration (``key``)."""
    device = resolve_device(device)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        if key and str(data["key"]) != key:
            return None  # stale artifact for a different rig/grid
        return carve_ops.ProjectionTables(
            valid=torch.from_numpy(data["valid"]).to(device),
            lin_idx=torch.from_numpy(data["lin_idx"]).to(device),
            image_hw=tuple(int(x) for x in data["image_hw"]),
        )


def cached_projection_tables(
    cameras: Sequence[CameraParams],
    grid: GridConfig,
    image_hw,
    cache_dir: str = "artifacts/tables",
    device="cuda",
) -> carve_ops.ProjectionTables:
    """Build-or-load the carve tables on ``device``, keyed by the full
    configuration."""
    device = resolve_device(device)
    key = _config_key(cameras, grid, image_hw)
    path = os.path.join(cache_dir, f"proj_{key}.npz")
    cached = load_projection_tables(path, key, device)
    if cached is not None:
        return cached
    tables = carve_ops.build_projection_tables(
        cameras, grid, tuple(image_hw), accelerate=True, device=device)
    save_projection_tables(path, tables, key)
    return tables


def from_numpy_state(state, device="cuda") -> MOGState:
    """Any object with ``weight``/``mean``/``var``/``nframes`` array
    attributes (e.g. the JAX package's ``MOGState`` after ``np.asarray``)
    → the port's ``MOGState`` on ``device``.  Cameras carry over with
    ``CameraParams.from_arrays(K, dist, rvec, tvec)``."""
    device = resolve_device(device)

    def f32(a):  # a writable copy, so the tensor owns its memory
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return MOGState(
        weight=f32(state.weight),
        mean=f32(state.mean),
        var=f32(state.var),
        nframes=torch.tensor(int(np.asarray(state.nframes)),
                             dtype=torch.int32, device=device),
    )


def train_state_from_numpy(state, device="cuda") -> MOGTrainState:
    """Any object with ``weight``/``sort_key``/``mean``/``var``/``nframes``
    array attributes in the training layout ((K, HW) / (3, K, HW); e.g.
    the JAX package's ``MOGTrainState`` after ``np.asarray``) → the port's
    ``MOGTrainState`` on ``device``, with the high-water mark ``used`` that
    the port's state carries computed from the weights and keys."""
    device = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    weight, sort_key = f32(state.weight), f32(state.sort_key)
    return MOGTrainState(
        weight=weight, sort_key=sort_key,
        mean=f32(state.mean), var=f32(state.var),
        nframes=torch.tensor(int(np.asarray(state.nframes)),
                             dtype=torch.int32, device=device),
        used=slot_high_water(weight, sort_key),
    )


def train_state_to_numpy(state: MOGTrainState) -> SimpleNamespace:
    """The port's ``MOGTrainState`` as numpy arrays under the same field
    names (``nframes`` an int32 scalar), ready for the JAX package's
    ``MOGTrainState(**vars(...))``, which has no ``used``: it is dropped."""
    return SimpleNamespace(
        weight=state.weight.cpu().numpy(),
        sort_key=state.sort_key.cpu().numpy(),
        mean=state.mean.cpu().numpy(), var=state.var.cpu().numpy(),
        nframes=np.int32(int(state.nframes)),
    )


def save_mog_state(path: str, state: MOGState) -> None:
    """Persist a background model (schema 2: ``var`` = per-mixture total
    variance, slots in OpenCV storage order)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        weight=state.weight.cpu().numpy(),
        mean=state.mean.cpu().numpy(),
        var=state.var.cpu().numpy(),
        nframes=np.asarray(int(state.nframes), dtype=np.int32),
        schema=np.int32(2),
    )


def load_mog_state(path: str, device="cuda"):
    """The saved state, or None when the file is missing or of another
    schema."""
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        if "schema" not in d or int(d["schema"]) != 2:
            return None
        arrays = SimpleNamespace(**{k: d[k] for k in MOGState._fields})
    return from_numpy_state(arrays, device)
