"""assimp2json model loading for viewer props.

The port's own copy of ``vbr_tpu/viewer/models3d.py`` (JSON and numpy, the
same operations): the reference renders camera/cube/square props from
assimp2json files (``resources/models/*.json``, loaded at
engine/renderable/model.py:9-24): a ``meshes`` list with flat
``vertices``/``normals``/``texturecoords`` and ``faces`` index triples
under a ``rootnode`` transform hierarchy.  This loader parses that format
into numpy arrays for either GL upload or the headless renderer; vertices
are transformed in f64 and stored as f32.
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Optional

import numpy as np


class MeshData(NamedTuple):
    vertices: np.ndarray  # (V, 3) f32
    normals: Optional[np.ndarray]  # (V, 3) f32 or None
    uvs: Optional[np.ndarray]  # (V, 2) f32 or None
    faces: np.ndarray  # (F, 3) i32


def _node_transforms(node, parent=np.eye(4)):
    """Flatten the rootnode hierarchy into {mesh index: 4×4 transform}."""
    out = {}
    m = np.asarray(
        node.get("transformation", np.eye(4).reshape(-1)), dtype=np.float64
    ).reshape(4, 4)
    world = parent @ m
    for mi in node.get("meshes", []):
        out[mi] = world
    for child in node.get("children", []):
        out.update(_node_transforms(child, world))
    return out


def load_assimp_json(path: str, apply_transforms: bool = True) -> List[MeshData]:
    """Parse an assimp2json model file into mesh arrays."""
    with open(path) as f:
        doc = json.load(f)
    transforms = {}
    if apply_transforms and "rootnode" in doc:
        transforms = _node_transforms(doc["rootnode"])

    meshes = []
    for i, m in enumerate(doc.get("meshes", [])):
        verts = np.asarray(m["vertices"], np.float64).reshape(-1, 3)
        if i in transforms:
            T = transforms[i]
            verts = verts @ T[:3, :3].T + T[:3, 3]
        normals = (
            np.asarray(m["normals"], np.float32).reshape(-1, 3)
            if m.get("normals")
            else None
        )
        uvs = None
        tc = m.get("texturecoords")
        if tc:
            # assimp2json: list of UV channels; channel 0, stride 2 or 3
            ch0 = np.asarray(tc[0], np.float32)
            stride = len(ch0) // len(verts)
            uvs = ch0.reshape(-1, stride)[:, :2]
        faces = np.asarray(m["faces"], np.int32).reshape(-1, 3)
        meshes.append(
            MeshData(verts.astype(np.float32), normals, uvs, faces)
        )
    return meshes


def mesh_to_tris(meshes: List[MeshData]) -> np.ndarray:
    """Flatten loaded meshes into a (T, 3, 3) triangle soup."""
    tris = []
    for m in meshes:
        tris.append(m.vertices[m.faces])
    return (
        np.concatenate(tris) if tris else np.zeros((0, 3, 3), np.float32)
    )


def mesh_to_tris_uv(meshes: List[MeshData]):
    """Flatten meshes into ((T, 3, 3) vertices, (T, 3, 2) UVs).

    Meshes without a UV channel contribute zero UVs (they sample the
    texture's corner texel — visually the reference's behavior, whose
    vertex shader forwards whatever assimp supplied,
    resources/shaders/vert.vs + engine/renderable/model.py).
    """
    tris, uvs = [], []
    for m in meshes:
        tris.append(m.vertices[m.faces])
        if m.uvs is not None:
            uvs.append(m.uvs[m.faces])
        else:
            uvs.append(np.zeros((len(m.faces), 3, 2), np.float32))
    if not tris:
        return (np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 2), np.float32))
    return np.concatenate(tris), np.concatenate(uvs)
