"""Drop-in replacement for the reference's ``assignment`` module API.

Counterpart of ``vbr_tpu/apps/assignment_api.py``.  A viewer written
against the reference's 4-function seam (generate_grid /
set_voxel_positions / get_cam_positions / get_cam_rotation_matrices, with
the stateful semantics of the reference's ``assignment.py``) runs on the
port once the module is configured:

    from vbr_tpu_torch.apps import assignment_api as assignment
    assignment.configure("data")
    positions, colors = assignment.set_voxel_positions(128, 64, 128)

As in ``vbr_tpu``, the frames are the rig's ``cam*/video.avi`` and the
background models are trained on its ``cam*/background.avi`` (kernel K3);
``configure`` also takes another frame source (``utils.video.ArraySource``)
and the models' npz directory or decoded background frames.  The model
(rig, background models, carve tables) is made on the first
``set_voxel_positions`` call, and each call takes one frame of every
camera from the source.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

from vbr_tpu_torch.models.visual_hull import VisualHull
from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.pipelines import reconstruction
from vbr_tpu_torch.utils import xmlio
from vbr_tpu_torch.utils.config import GridConfig

block_size = 1.0

# module state, as the reference's assignment.py keeps it
_data_dir: Optional[str] = None
_source = None
_background = None
_device = "cuda"
_model_kw: dict = {}
_model = None


def configure(data_dir: Optional[str], source=None,
              background: Union[None, str, Sequence[np.ndarray]] = None,
              device="cuda", **model_kw) -> None:
    """Point the module at a rig and a stream; drops any model made before.

    ``data_dir`` holds ``cam{i}/config.xml`` and ``checkerboard.xml``;
    ``source`` has ``next_frames()`` → (C, H, W, 3) u8 BGR or None at the
    end (default: ``utils.video.MultiCameraSource(data_dir)``, opened at the
    first ``set_voxel_positions``); ``background`` is a directory of
    ``mog_cam{i}.npz`` (as ``VisualHull.save_background_models`` of either
    package writes them), one sequence of decoded background frames per
    camera, (T, H, W, 3) u8, or None: the rig's ``cam{i}/background.avi``.
    Both are trained with kernel K3.  ``device`` and ``model_kw`` go to
    ``VisualHull.from_data_dir``."""
    global _data_dir, _source, _background, _device, _model_kw, _model
    _data_dir = data_dir
    _source = source
    _background = background
    _device = device
    _model_kw = dict(model_kw)
    _model = None


def generate_grid(width: int, depth: int):
    """Checkerboard floor tiles (the reference's semantics)."""
    return reconstruction.generate_grid(width, depth)


def _make_model(grid: GridConfig) -> VisualHull:
    model = VisualHull.from_data_dir(_data_dir, grid, train_background=False,
                                     device=_device, **_model_kw)
    if isinstance(_background, (str, os.PathLike)):
        if not model.load_background_models(str(_background)):
            raise FileNotFoundError(
                f"no mog_cam{{1..{model.rig.num_cameras}}}.npz in "
                f"{_background}")
    else:
        model.train_background(_data_dir if _background is None
                               else _background)
    return model


def set_voxel_positions(width: int, height: int, depth: int):
    """Take one frame of every camera, carve, return (positions, colors)
    as lists.

    ``height`` is HALF the Y voxel count, like the reference.  The grid is
    fixed by the first call.  Returns ([], []) at the end of the stream."""
    global _model, _source
    if _data_dir is None:
        raise RuntimeError("call configure(data_dir) first")
    if _model is None:
        _model = _make_model(GridConfig(nx=width, ny=height * 2, nz=depth))
        if _source is None:
            from vbr_tpu_torch.utils.video import MultiCameraSource

            _source = MultiCameraSource(_data_dir)

    frames = _source.next_frames()
    if frames is None:
        return [], []
    occ, col = _model.process_frame_fast(frames)
    positions, colors = carve_ops.compact_voxels(
        occ, col, _model.grid, _model.rig.scaling_factor)
    return positions.tolist(), colors.tolist()


def get_cam_positions():
    """Camera centres in viewer coordinates + per-camera colours."""
    cams = reconstruction.load_rig(_data_dir)
    (_, square) = xmlio.load_chessboard_info(
        os.path.join(_data_dir, "checkerboard.xml"))
    return reconstruction.get_cam_positions(cams, square)


def get_cam_rotation_matrices():
    """4×4 viewer-space camera rotations."""
    return reconstruction.get_cam_rotation_matrices(
        reconstruction.load_rig(_data_dir))
