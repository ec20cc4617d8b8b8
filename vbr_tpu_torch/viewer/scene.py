"""Scene composition helpers (pure math, no GL).

The port's own copy of ``vbr_tpu/viewer/scene.py``, on the port's
``pipelines/reconstruction.py``, ``ops/camera.py`` and ``utils/config.py``
(host f64 numpy with the same operations, so every array equals
``vbr_tpu``'s, dtype included).  Everything the viewer needs beyond
instanced voxels, kept GL-free so it is testable headlessly:

  * assimp-JSON prop loading with per-camera rotation baked in — the
    reference's camera/square/cube models (executable.py:110-112,125-127)
  * camera frustum wireframe segments (an upgrade over the reference,
    which renders only the camera body model)
  * world-mm → viewer-coordinate conversion for marching-cubes surfaces
    (the axis swap + 1/64 scale of assignment.py:127-129)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from vbr_tpu_torch.ops import camera as cam_ops
from vbr_tpu_torch.pipelines.reconstruction import (
    BLOCK_SIZE,
    generate_grid,
    get_cam_positions,
    get_cam_rotation_matrices,
)
from vbr_tpu_torch.utils.config import CameraParams
from vbr_tpu_torch.viewer import models3d


def default_resources_dir(data_dir: str) -> str:
    """The reference repo layout puts ``resources/`` beside ``data/``."""
    return os.path.join(os.path.dirname(os.path.abspath(data_dir)),
                        "resources", "models")


def load_prop_tris(resources_dir: str, name: str) -> Optional[np.ndarray]:
    """(T, 3, 3) f32 triangle soup for a named assimp-JSON prop, or None."""
    path = os.path.join(resources_dir, f"{name}.json")
    if not os.path.isfile(path):
        return None
    return models3d.mesh_to_tris(models3d.load_assimp_json(path))


def camera_model_tris(
    cameras: Sequence[CameraParams],
    resources_dir: str,
    scale: float = 1.0,
) -> List[np.ndarray]:
    """Per-camera triangle soup with the viewer rotation baked in.

    The reference constructs ``Model('camera.json', rotation)`` per camera
    (executable.py:110) and draws it at the camera position — the rotation
    is a per-model constant, so we pre-transform the vertices on the host
    instead of adding a model-matrix uniform to the instanced shader.
    Falls back to a unit cube when the model file is absent (e.g. the
    LFS-stripped mount).
    """
    tris = load_prop_tris(resources_dir, "camera")
    if tris is None:
        tris = unit_cube_tris() * 2.0
    tris = tris * scale
    rots = get_cam_rotation_matrices(cameras)
    out = []
    for M in rots:
        R = M[:3, :3]
        out.append((tris.reshape(-1, 3) @ R.T).reshape(-1, 3, 3)
                   .astype(np.float32))
    return out


def unit_cube_tris() -> np.ndarray:
    """(12, 3, 3) unit cube triangle soup centered at the origin."""
    from vbr_tpu_torch.viewer.gl_engine import CUBE_VERTS

    return CUBE_VERTS.reshape(-1, 3, 3).copy()


def camera_frustum_segments(
    cp: CameraParams,
    image_hw=(486, 644),
    depth_mm: float = 700.0,
    square_size_mm: float = 115.0,
) -> np.ndarray:
    """(8, 2, 3) viewer-coordinate line segments of a camera's frustum.

    Four rays from the optical center through the image corners at
    ``depth_mm``, plus the far rectangle.  Distortion is ignored (a
    wireframe is a visual aid, not a measurement).  Viewer coordinates
    follow the reference conversion: world mm → (x, -z, y)/square_size
    (assignment.py:152-177).
    """
    H, W = image_hw
    R = cam_ops.rodrigues(np.asarray(cp.rvec, np.float64))
    t = np.asarray(cp.tvec, np.float64).reshape(3)
    K = np.asarray(cp.K, np.float64)
    center = -R.T @ t  # world mm

    corners_px = np.array(
        [[0, 0], [W, 0], [W, H], [0, H]], np.float64
    )
    Kinv = np.linalg.inv(K)
    far = []
    for u, v in corners_px:
        d_cam = Kinv @ np.array([u, v, 1.0])
        d_cam = d_cam / d_cam[2] * depth_mm  # camera-frame point at depth
        far.append(R.T @ (d_cam - t))
    far = np.asarray(far)  # (4, 3) world mm

    def to_viewer(p):
        p = p / square_size_mm
        return np.stack([p[..., 0], -p[..., 2], p[..., 1]], axis=-1)

    c_v = to_viewer(center)
    far_v = to_viewer(far)
    segs = [np.stack([c_v, far_v[i]]) for i in range(4)]
    segs += [np.stack([far_v[i], far_v[(i + 1) % 4]]) for i in range(4)]
    return np.asarray(segs, np.float32)


def rig_frustum_segments(
    cameras: Sequence[CameraParams], image_hw=(486, 644), **kw
) -> np.ndarray:
    """Concatenated frustum segments for the whole rig: (8·C, 2, 3)."""
    return np.concatenate(
        [camera_frustum_segments(cp, image_hw, **kw) for cp in cameras]
    )


def surface_tris_to_viewer(
    tris_mm: np.ndarray, scaling_factor: float = 64.0
) -> np.ndarray:
    """World-mm marching-cubes triangles → viewer coords.

    Same conversion as the voxel positions (assignment.py:127-129):
    (x, -z, y) / scaling_factor.  This map is a proper rotation
    (determinant +1), so triangle winding — and outward normals — are
    preserved without a vertex swap.
    """
    t = np.asarray(tris_mm, np.float32) / scaling_factor
    return np.stack([t[..., 0], -t[..., 2], t[..., 1]], axis=-1)


def prop_texture_path(resources_dir: str, name: str = "diffuse",
                      grid: bool = False) -> str:
    """Path of a reference texture (resources/textures beside the model
    dir; executable.py:113-120 loads diffuse/normal/specular/depth plus
    their *_grid variants)."""
    tex_dir = os.path.join(os.path.dirname(os.path.abspath(resources_dir)),
                           "textures")
    return os.path.join(tex_dir, f"{name}_grid.jpg" if grid else
                        f"{name}.jpg")


def load_prop_textured(resources_dir: str, name: str):
    """((T,3,3) tris, (T,3,2) uvs) for a named assimp prop, or None."""
    path = os.path.join(resources_dir, f"{name}.json")
    if not os.path.isfile(path):
        return None
    return models3d.mesh_to_tris_uv(models3d.load_assimp_json(path))


def floor_textured_tris(world_width: int, world_depth: int):
    """One textured quad covering the floor-grid extent.

    Same world placement as generate_grid (assignment.py:43-51: cell x
    spans [x·bs − w/2, ...] at y = −bs) with one texture repeat per
    2×2-cell checker period, so the reference's diffuse_grid.jpg tiles
    match the instanced black/white squares cell-for-cell.
    """
    x0, x1 = -world_width / 2, world_width * BLOCK_SIZE - world_width / 2
    z0, z1 = -world_depth / 2, world_depth * BLOCK_SIZE - world_depth / 2
    y = -BLOCK_SIZE
    quad = np.array([
        [[x0, y, z0], [x0, y, z1], [x1, y, z1]],
        [[x0, y, z0], [x1, y, z1], [x1, y, z0]],
    ], np.float32)
    u1, v1 = world_width / 2.0, world_depth / 2.0
    uvq = np.array([
        [[0, 0], [0, v1], [u1, v1]],
        [[0, 0], [u1, v1], [u1, 0]],
    ], np.float32)
    return quad, uvq


def floor_and_cam_instances(cameras, world_width: int, world_depth: int):
    """Floor checkerboard + camera positions/colors (viewer contract)."""
    floor_pos, floor_col = generate_grid(world_width, world_depth)
    cam_pos, cam_col = get_cam_positions(cameras)
    return (
        np.asarray(floor_pos, np.float32),
        np.asarray(floor_col, np.float32),
        np.asarray(cam_pos, np.float32),
        np.asarray(cam_col, np.float32),
    )
