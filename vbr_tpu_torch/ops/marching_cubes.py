"""Isosurface extraction from the carved occupancy volume (PyTorch).

Counterpart of ``vbr_tpu/ops/marching_cubes.py``: the generated case
tables (6-tetrahedra decomposition and classic 256-case marching cubes
with the ``separate`` / ``join`` ambiguity rules), the tiling registry,
the per-cell emitters, the binary fast path (a 256-entry table of the
triangles each corner configuration emits), ``extract_mesh`` and the
device-resident ``surface_program`` / ``surface_wire_program`` with their
host tails.

The tables are numpy, built exactly as the JAX package builds them.  The
per-cell emitters are tensor ops vectorised over cells; the table emitter
gathers ``table[cfg] + base`` (one f32 add), and the active-cell
compaction is a cumulative sum and a scatter, so ``surface_program`` runs
on the tensor's device without waiting for the host.  Every result a
caller keeps is bit for bit the JAX package's (a truncated compaction's
slots past the cells it kept hold 0 here): the generated tables come from
running this module's own emitters, and world placement stays two f32
numpy roundings on the host (:func:`world_triangles`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from vbr_tpu_torch import native
from vbr_tpu_torch.ops.carve import to_host
from vbr_tpu_torch.utils.device import resolve_device

# Cube corner offsets, id = bit order (dx, dy, dz)
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
    ],
    dtype=np.int32,
)

# 6-tetrahedra decomposition of the cube around the 0-7 diagonal.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int32,
)

# Tet edges by local corner pair
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# Case table: for each 4-bit inside mask, up to 2 triangles as triples of
# tet-edge ids (−1 padding).  Orientation fixed numerically afterwards.
_E01, _E02, _E03, _E12, _E13, _E23 = range(6)
_CASES = -np.ones((16, 2, 3), dtype=np.int32)
_CASES[1, 0] = [_E01, _E02, _E03]                      # v0 inside
_CASES[2, 0] = [_E01, _E12, _E13]                      # v1
_CASES[4, 0] = [_E02, _E12, _E23]                      # v2
_CASES[8, 0] = [_E03, _E13, _E23]                      # v3
_CASES[3] = [[_E02, _E03, _E13], [_E02, _E13, _E12]]   # v0 v1
_CASES[5] = [[_E01, _E03, _E23], [_E01, _E23, _E12]]   # v0 v2
_CASES[9] = [[_E01, _E13, _E23], [_E01, _E23, _E02]]   # v0 v3
_CASES[6] = [[_E01, _E02, _E23], [_E01, _E23, _E13]]   # v1 v2
_CASES[10] = [[_E01, _E12, _E23], [_E01, _E23, _E03]]  # v1 v3
_CASES[12] = [[_E02, _E03, _E13], [_E02, _E13, _E12]]  # v2 v3
for _m in (1, 2, 4, 8, 3, 5, 9, 6, 10, 12):
    _CASES[15 - _m] = _CASES[_m]


# ---------------------------------------------------------------------------
# Classic 256-case marching cubes
# ---------------------------------------------------------------------------
#
# The 256-case triangle table is GENERATED, not transcribed: for each corner
# configuration, the cut points on each cube face are paired into directed
# segments ("inside region on the left, viewed from outside the cell"), the
# segments chain into closed loops, and each loop is fan-triangulated.  The
# pairing depends only on the shared face's corner states, so adjacent
# cells agree and the mesh is watertight across cells.
#
# Two ambiguity rules (the ambiguous face = two diagonal inside corners):
#
# * ``separate`` — the diagonal inside pair is cut apart; surface
#   components follow 6-connectivity of the inside voxels.
# * ``join`` — the diagonal inside pair is connected (segments around each
#   OUTSIDE corner), and loops bounding the same outside-corner component
#   are triangulated as one patch (tube).  This is what skimage's Lewiner
#   MC33 (the reference's ``skimage.measure.marching_cubes`` call,
#   voxel_reconstruction.py:142) resolves on a BINARY volume: its face and
#   interior tests evaluate to "join" for inside=1 / outside=0.  Surface
#   components follow 26-connectivity of the inside voxels.


def _build_mc_tables(ambig: str = "separate"):
    """Generate (tri_table (256, MAXT, 3) edge ids, edge midpoints (12, 3)).

    Corner index bit layout matches ``_CORNERS``: bit0=dx, bit1=dy, bit2=dz.
    ``ambig`` picks the ambiguous-face rule ("separate" | "join", above).
    """
    corners = np.array(
        [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
        np.float64,
    )
    edges = sorted(
        (a, b)
        for a in range(8)
        for b in range(a + 1, 8)
        if bin(a ^ b).count("1") == 1
    )
    eid = {e: i for i, e in enumerate(edges)}
    mids = np.array(
        [(corners[a] + corners[b]) / 2 for a, b in edges], np.float32
    )

    def face_corners(axis, side):
        a1, a2 = [ax for ax in range(3) if ax != axis]
        return [
            (side << axis) | (b1 << a1) | (b2 << a2)
            for b1, b2 in ((0, 0), (1, 0), (1, 1), (0, 1))
        ]

    tri_lists = []
    for cfg in range(256):
        inside = [(cfg >> i) & 1 for i in range(8)]
        segs = {}
        for axis in range(3):
            for side in (0, 1):
                n = np.zeros(3)
                n[axis] = 1.0 if side == 1 else -1.0
                cs = face_corners(axis, side)
                fedges = [
                    tuple(sorted((cs[k], cs[(k + 1) % 4]))) for k in range(4)
                ]
                cut = [
                    k for k in range(4)
                    if inside[cs[k]] != inside[cs[(k + 1) % 4]]
                ]
                ins = [k for k in range(4) if inside[cs[k]]]
                if not cut:
                    continue

                def seg(k1, k2, ref_corner):
                    e1, e2 = eid[fedges[k1]], eid[fedges[k2]]
                    m1, m2 = mids[e1], mids[e2]
                    left = np.cross(m2 - m1, corners[ref_corner] - m1)
                    return (e1, e2) if np.dot(left, n) > 0 else (e2, e1)

                if len(cut) == 2:
                    a, b = seg(cut[0], cut[1], cs[ins[0]])
                    segs[a] = b
                elif ambig == "separate":
                    # cut the diagonal inside pair apart
                    for k in ins:
                        a, b = seg((k - 1) % 4, k, cs[k])
                        segs[a] = b
                else:
                    # join the inside pair: segments around each OUTSIDE
                    # corner; the neighbouring (inside) corner is the
                    # left-of-segment orientation reference
                    for k in range(4):
                        if inside[cs[k]]:
                            continue
                        a, b = seg((k - 1) % 4, k, cs[(k + 1) % 4])
                        segs[a] = b
        # every cut edge must appear exactly once as source and once as
        # target — the direction convention chains across faces
        if sorted(segs) != sorted(segs.values()):
            raise AssertionError(f"config {cfg}: segments do not chain")
        loops = []
        visited = set()
        for start in sorted(segs):
            if start in visited:
                continue
            loop = [start]
            visited.add(start)
            cur = segs[start]
            while cur != start:
                loop.append(cur)
                visited.add(cur)
                cur = segs[cur]
            loops.append(loop)

        if ambig == "join" and len(loops) > 1:
            # group loops by the outside-corner component they bound
            # (outside corners join only via cube EDGES; diagonal joins
            # belong to the inside region under the binary MC33 tests)
            parent = list(range(8))

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for a in range(8):
                for b in range(a + 1, 8):
                    if (
                        bin(a ^ b).count("1") == 1
                        and not inside[a] and not inside[b]
                    ):
                        parent[find(a)] = find(b)

            def loop_comp(loop):
                comps = {
                    find(a if not inside[a] else b)
                    for e in loop
                    for a, b in (edges[e],)
                }
                if len(comps) != 1:
                    raise AssertionError(f"config {cfg}: loop {loop} "
                                         f"bounds components {comps}")
                return comps.pop()

            groups = {}
            for loop in loops:
                groups.setdefault(loop_comp(loop), []).append(loop)
            patches = list(groups.values())
        else:
            patches = [[loop] for loop in loops]

        tris = []
        for patch in patches:
            if len(patch) == 1:
                loop = patch[0]
                for i in range(1, len(loop) - 1):
                    tris.append((loop[0], loop[i], loop[i + 1]))
            elif len(patch) == 2:
                # tube between two boundary loops: zip A (chain order)
                # against reversed B so both loops' directed segments
                # appear in chain direction (watertight across cells)
                a, b = patch
                b2 = b[::-1]
                # rotate b2 so its head is nearest a[0]
                d = [np.linalg.norm(mids[e] - mids[a[0]]) for e in b2]
                r = int(np.argmin(d))
                b2 = b2[r:] + b2[:r]
                p, q = len(a), len(b2)
                i = j = 0
                while i < p or j < q:
                    if j >= q or (i < p and i * q <= j * p):
                        tris.append((a[i % p], a[(i + 1) % p], b2[j % q]))
                        i += 1
                    else:
                        tris.append(
                            (a[i % p], b2[(j + 1) % q], b2[j % q])
                        )
                        j += 1
            else:  # pragma: no cover - not reachable for 256 configs
                raise AssertionError(
                    f"config {cfg}: {len(patch)}-loop patch unsupported"
                )
        tri_lists.append(tris)

    maxt = max(len(t) for t in tri_lists)
    table = -np.ones((256, maxt, 3), np.int32)
    for cfg, tris in enumerate(tri_lists):
        for i, t in enumerate(tris):
            table[cfg, i] = t

    # orientation sanity at generation time: single-corner config's
    # triangle normal must point away from the inside corner
    t0 = table[1, 0]
    v = mids[t0]
    nrm = np.cross(v[1] - v[0], v[2] - v[0])
    if np.dot(nrm, v.mean(0) - corners[0]) < 0:
        table = table[:, :, ::-1]  # flip winding globally
    return table, mids


_MC_TABLE_NP, _MC_MIDS_NP = _build_mc_tables("separate")
_MC_TABLE_JOIN_NP, _ = _build_mc_tables("join")
# ambiguity rule → (256, T, 3) edge-id table (contiguous: a winding flip
# leaves a reversed view): the two built-in rules and the tilings
# registered by ``register_tiling`` / ``load_tiling``
_MC_TABLES = {"separate": np.ascontiguousarray(_MC_TABLE_NP),
              "join": np.ascontiguousarray(_MC_TABLE_JOIN_NP)}

# edge id -> (corner a, corner b), same ordering as _build_mc_tables
_MC_EDGE_CORNERS_NP = np.array(
    sorted(
        (a, b)
        for a in range(8)
        for b in range(a + 1, 8)
        if bin(a ^ b).count("1") == 1
    ),
    np.int32,
)

# optional on-disk path of the "mc33" tiling; None: vbr_tpu_torch/data
_MC33_NPZ = None


def known_ambiguities():
    """Built-in ambiguity rules + registered tiling names."""
    return ("separate", "join") + tuple(
        k for k in _MC_TABLES if k not in ("separate", "join"))


def _check_ambiguity(ambiguity: str):
    if ambiguity not in _MC_TABLES:
        raise ValueError(
            f"unknown ambiguity rule {ambiguity!r}; known: "
            f"{known_ambiguities()} (external tilings must be "
            "registered first — see register_tiling / "
            "scripts/derive_mc33_tiling.py)"
        )


def _mc_maxt(ambiguity: str) -> int:
    return _MC_TABLES[ambiguity].shape[1]


def register_tiling(name: str, table: np.ndarray):
    """Register an external (256, T, 3) edge-id triangle table under
    ``name`` so every consumer (``extract_mesh``, ``surface_program``,
    ``table_emitter``) accepts ``ambiguity=name``.

    Validation, per config: every triangle uses only CUT edges of its
    config, every cut edge is used by at least one triangle, and the
    config's cut-edge set equals the built-in ``join`` table's (on a binary
    volume Lewiner's MC33 face and interior tests always resolve to
    *join*, so any candidate MC33 tiling must agree on which edges carry
    vertices).
    """
    table = np.asarray(table, np.int32)
    if table.ndim != 3 or table.shape[0] != 256 or table.shape[2] != 3:
        raise ValueError(f"tiling table must be (256, T, 3); "
                         f"got {table.shape}")
    if name in ("separate", "join", "tetrahedra"):
        raise ValueError(f"cannot override built-in rule {name!r}")
    for cfg in range(256):
        inside = [(cfg >> k) & 1 for k in range(8)]
        cut = {
            e for e, (a, b) in enumerate(_MC_EDGE_CORNERS_NP)
            if inside[a] != inside[b]
        }
        tris = table[cfg][table[cfg, :, 0] >= 0]
        used = set(int(e) for e in tris.ravel())
        if not used <= cut:
            raise ValueError(
                f"config {cfg}: triangle uses non-cut edge(s) "
                f"{sorted(used - cut)}")
        if cut and used != cut:
            raise ValueError(
                f"config {cfg}: cut edges {sorted(cut - used)} carry no "
                "triangle (vertex set would differ from MC33-on-binary)")
        ref = _MC_TABLE_JOIN_NP[cfg]
        ref_used = set(int(e) for e in ref[ref[:, 0] >= 0].ravel())
        if used != ref_used:
            raise ValueError(
                f"config {cfg}: edge set differs from the join table "
                "(MC33 on a binary volume joins diagonal inside corners)")
    _MC_TABLES[name] = np.ascontiguousarray(table)
    # a name registered again must not serve the tables of its old tiling
    for cache in (_BINARY_EMIT_TABLES, _DEVICE_TABLES):
        for key in [k for k in cache if k[1] == name]:
            del cache[key]


def load_tiling(name: str, path: str):
    """Register the tiling table stored in ``path`` (.npz with a ``table``
    array, as written by scripts/derive_mc33_tiling.py)."""
    with np.load(path) as z:
        register_tiling(name, z["table"])


def _ensure_tiling(ambiguity: str):
    """Validate ``ambiguity``, loading the on-disk "mc33" table
    (vbr_tpu_torch/data/mc33_tiling.npz, produced by
    scripts/derive_mc33_tiling.py on a machine with scikit-image) on first
    use."""
    if ambiguity in _MC_TABLES:
        return
    if ambiguity == "mc33":
        path = _MC33_NPZ or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "data",
            "mc33_tiling.npz")
        if os.path.exists(path):
            load_tiling("mc33", path)
            return
        raise ValueError(
            "ambiguity='mc33' needs the derived Lewiner tiling table "
            "(vbr_tpu_torch/data/mc33_tiling.npz), which the repository "
            "does not ship: deriving it needs scikit-image.  On a machine "
            "with scikit-image run scripts/derive_mc33_tiling.py and point "
            "marching_cubes.load_tiling('mc33', <npz>) at the result; "
            "ambiguity='join' gives the same vertices and topology with "
            "this library's own tiling."
        )
    _check_ambiguity(ambiguity)


def derive_tiling_from_oracle(oracle, level: float = 0.25):
    """Derive a (256, T, 3) edge-id tiling table by RUNNING an external
    marching-cubes implementation on 256 isolated single-cell volumes.

    ``oracle(volume (2,2,2) f32, level) -> (verts (N, 3), faces (M, 3))``
    — e.g. ``lambda v, l: skimage.measure.marching_cubes(v, l)[:2]``.
    ``level`` must be strictly inside (0, 1); a non-degenerate level is
    required so every vertex maps to a UNIQUE edge crossing (at level 0
    vertices collapse onto corners).  The recovered table is
    level-independent: the tiling is a pure function of the 8-bit config.

    Raises if any oracle vertex does not lie (within 1e-6) on a cut edge's
    crossing point — the recovery is exact or it fails loudly.
    """
    if not 0.0 < level < 1.0:
        raise ValueError("level must be inside (0, 1)")
    corners = _CORNERS.astype(np.float64)
    tri_lists = []
    for cfg in range(256):
        vol = np.zeros((2, 2, 2), np.float32)
        inside = [(cfg >> k) & 1 for k in range(8)]
        for k, (dx, dy, dz) in enumerate(_CORNERS):
            vol[dx, dy, dz] = float(inside[k])
        if cfg in (0, 255):
            tri_lists.append(np.zeros((0, 3), np.int32))
            continue
        verts, faces = oracle(vol, level)
        verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int64)
        # expected crossing point of each cut edge at ``level``
        exp = {}
        for e, (a, b) in enumerate(_MC_EDGE_CORNERS_NP):
            va, vb = float(inside[a]), float(inside[b])
            if va == vb:
                continue
            t = (va - level) / (va - vb)
            exp[e] = corners[a] + t * (corners[b] - corners[a])
        vert_edge = np.full(len(verts), -1, np.int64)
        for i, v in enumerate(verts):
            for e, p in exp.items():
                if np.linalg.norm(v - p) < 1e-6:
                    vert_edge[i] = e
                    break
            if vert_edge[i] < 0:
                raise ValueError(
                    f"config {cfg}: oracle vertex {v} is not on any cut "
                    "edge's level-crossing — not a per-cell marching "
                    "cubes at this level")
        tri_lists.append(vert_edge[faces].astype(np.int32))
    maxt = max(len(t) for t in tri_lists)
    table = -np.ones((256, maxt, 3), np.int32)
    for cfg, tris in enumerate(tri_lists):
        if len(tris):
            table[cfg, : len(tris)] = tris
    return table


# ---------------------------------------------------------------------------
# Per-cell emitters (tensor ops, vectorised over cells)
# ---------------------------------------------------------------------------


def _as_volume(volume, device="cuda") -> torch.Tensor:
    """``volume`` as a tensor: a tensor stays where it is; a numpy array
    goes to ``device`` (the card unless the caller asks for the CPU)."""
    if isinstance(volume, torch.Tensor):
        return volume
    return torch.from_numpy(np.ascontiguousarray(volume)).to(
        resolve_device(device))


def _cell_corners(vol: torch.Tensor, cell_idx: torch.Tensor):
    """(base (n, 3) i64 cell coordinates, vals (n, 8) f32 corner values)
    of flat cell indices into the (nx-1, ny-1, nz-1) cell grid."""
    nx, ny, nz = vol.shape
    idx = cell_idx.long()
    cz = idx % (nz - 1)
    cy = (idx // (nz - 1)) % (ny - 1)
    cx = idx // ((nz - 1) * (ny - 1))
    flat = vol.reshape(-1)
    lin0 = (cx * ny + cy) * nz + cz
    vals = torch.stack([flat[lin0 + (int(dx) * ny + int(dy)) * nz + int(dz)]
                        for dx, dy, dz in _CORNERS], dim=-1)
    return torch.stack([cx, cy, cz], dim=-1), vals


def _emit_triangles_mc(volume, cell_idx, *, capacity: int,
                       ambiguity: str = "separate", level: float = 0.5):
    """Classic-MC triangles for ``capacity`` active cells (padded with
    index 0).

    Vertices sit at the linear-interpolation crossing of ``level`` along
    each cut edge, ``pa + t·(pb − pa)`` with ``t = (va − level)/(va − vb)``
    (skimage's formula), each operation rounded to f32 on its own: for a
    binary volume at level 0 they land on the outside-corner lattice
    points, at 0.5 on edge midpoints.

    Returns (tris (capacity·MAXT, 3, 3) f32 voxel coords, valid mask)."""
    vol = volume.to(torch.float32)
    dev = vol.device
    base, vals = _cell_corners(vol, cell_idx)
    table = torch.from_numpy(_MC_TABLES[ambiguity]).to(dev).long()
    cfg = ((vals > level).long() << torch.arange(8, device=dev)).sum(-1)
    tri_edges = table[cfg]  # (n, MAXT, 3)
    valid = tri_edges[..., 0] >= 0
    pair = torch.from_numpy(_MC_EDGE_CORNERS_NP).to(dev).long()[
        tri_edges.clamp(0, 11)]  # (n, MAXT, 3, 2)
    n, maxt = tri_edges.shape[:2]
    va = vals.gather(1, pair[..., 0].reshape(n, -1)).reshape(n, maxt, 3)
    vb = vals.gather(1, pair[..., 1].reshape(n, -1)).reshape(n, maxt, 3)
    t = (va - level) / torch.where(va == vb, 1.0, va - vb)
    corners = torch.from_numpy(_CORNERS.astype(np.float32)).to(dev)
    pa, pb = corners[pair[..., 0]], corners[pair[..., 1]]
    verts = pa + t[..., None] * (pb - pa) + base[:, None, None, :].float()
    return verts.reshape(-1, 3, 3), valid.reshape(-1)


def _emit_triangles(volume, cell_idx, *, capacity: int):
    """Triangles for ``capacity`` active cells (padded with index 0): six
    tetrahedra per cell, up to two triangles each, at edge midpoints
    (level 0.5), each turned to face away from the tetrahedron's inside
    corners.

    Returns (tris (capacity·12, 3, 3) f32, valid (capacity·12,) bool) in
    voxel-index coordinates.
    """
    vol = volume.to(torch.float32)
    dev = vol.device
    base, vals = _cell_corners(vol, cell_idx)
    corners = torch.from_numpy(_CORNERS.astype(np.float32)).to(dev)
    corner_pos = base[:, None, :].float() + corners  # (n, 8, 3)
    tets = torch.from_numpy(_TETS).to(dev).long()
    tv = vals[:, tets]  # (n, 6, 4)
    tp = corner_pos[:, tets]  # (n, 6, 4, 3)
    inside = tv > 0.5
    case = (inside.long() << torch.arange(4, device=dev)).sum(-1)  # (n, 6)
    ea, eb = (torch.from_numpy(_TET_EDGES[:, k]).to(dev).long()
              for k in (0, 1))
    edge_mid = (tp[:, :, ea] + tp[:, :, eb]) * 0.5  # (n, 6, 6, 3)
    tri_edges = torch.from_numpy(_CASES).to(dev).long()[case]  # (n,6,2,3)
    valid = tri_edges[..., 0] >= 0
    n = tri_edges.shape[0]
    sel = tri_edges.clamp(0, 5).reshape(n, 6, 6, 1).expand(-1, -1, -1, 3)
    verts = edge_mid.gather(2, sel).reshape(n, 6, 2, 3, 3)

    # orient outward: flip if the normal points toward the inside set
    ins = inside[..., None]
    centroid_in = (torch.where(ins, tp, 0.0).sum(-2)
                   / inside.sum(-1, keepdim=True).clamp_min(1))
    centroid_out = (torch.where(~ins, tp, 0.0).sum(-2)
                    / (~inside).sum(-1, keepdim=True).clamp_min(1))
    outward = centroid_out - centroid_in  # (n, 6, 3)
    nrm = torch.linalg.cross(verts[..., 1, :] - verts[..., 0, :],
                             verts[..., 2, :] - verts[..., 0, :])
    flip = (nrm * outward[:, :, None, :]).sum(-1) < 0  # (n, 6, 2)
    verts = torch.where(flip[..., None, None], verts.flip(-2), verts)
    return verts.reshape(-1, 3, 3), valid.reshape(-1)


def active_cells_mask(volume, level: float = 0.5,
                      device="cuda") -> torch.Tensor:
    """(nx-1, ny-1, nz-1) bool: cells whose 8 corners straddle ``level``,
    on the volume's device (a numpy volume goes to ``device``)."""
    volume = _as_volume(volume, device)
    v = (volume.to(torch.float32) > level).to(torch.int32)
    s = (
        v[:-1, :-1, :-1] + v[1:, :-1, :-1] + v[:-1, 1:, :-1] + v[1:, 1:, :-1]
        + v[:-1, :-1, 1:] + v[1:, :-1, 1:] + v[:-1, 1:, 1:] + v[1:, 1:, 1:]
    )
    return (s > 0) & (s < 8)


def cell_configs(volume, level: float = 0.5, device="cuda") -> torch.Tensor:
    """(nx-1, ny-1, nz-1) u8: the 8-bit corner configuration of every cell
    (bit k set ⇔ corner ``_CORNERS[k]`` is above ``level``), by shifted
    integer adds; a cell is active ⇔ its config is neither 0 nor 255.  On
    the volume's device (a numpy volume goes to ``device``)."""
    volume = _as_volume(volume, device)
    v = (volume.to(torch.float32) > level).to(torch.int32)
    nx, ny, nz = volume.shape
    cfg = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.int32,
                      device=volume.device)
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        cfg = cfg + (v[dx:dx + nx - 1, dy:dy + ny - 1, dz:dz + nz - 1] << k)
    return cfg.to(torch.uint8)


# ---------------------------------------------------------------------------
# Binary fast path: the 256-entry emission table
# ---------------------------------------------------------------------------

# (algorithm, ambiguity, level) → (verts_rel, valid) numpy
_BINARY_EMIT_TABLES = {}
# (algorithm, ambiguity, level, device) → the same as tensors on device
_DEVICE_TABLES = {}


def _binary_emit_table(algorithm: str, ambiguity: str, level: float):
    """(verts_rel (256, T, 3, 3) f32, valid (256, T) bool) numpy: the
    triangles every corner configuration emits, relative to the cell base.

    For a BINARY volume the per-cell emission depends only on the 8-bit
    config, so it is tabulated once, by RUNNING this module's per-cell
    emitters (on the CPU) on 256 synthetic single-config cells (stride 4
    along z, so no two share a corner).  Valid for levels whose
    edge-crossing offsets are exact dyadics (0 and 0.5): there ``rel +
    base`` is exact f32 arithmetic, so re-basing is lossless.
    """
    key = (algorithm, ambiguity, float(level))
    if key in _BINARY_EMIT_TABLES:
        return _BINARY_EMIT_TABLES[key]
    vol = np.zeros((2, 2, 4 * 256), np.float32)
    for cfg in range(256):
        for k, (dx, dy, dz) in enumerate(_CORNERS):
            if cfg >> k & 1:
                vol[dx, dy, 4 * cfg + dz] = 1.0
    cells = torch.arange(256, dtype=torch.int64) * 4
    if algorithm == "tetrahedra":
        T = 12
        verts, valid = _emit_triangles(torch.from_numpy(vol), cells,
                                       capacity=256)
    else:
        T = _mc_maxt(ambiguity)
        verts, valid = _emit_triangles_mc(
            torch.from_numpy(vol), cells, capacity=256, ambiguity=ambiguity,
            level=float(level))
    verts = verts.numpy().reshape(256, T, 3, 3).copy()
    valid = valid.numpy().reshape(256, T)
    verts[..., 2] -= (np.arange(256, dtype=np.float32) * 4)[:, None, None]
    _BINARY_EMIT_TABLES[key] = (verts, valid)
    return verts, valid


def _device_table(key, device):
    """The binary emission table of ``key`` as tensors on ``device``
    (moved there once, so a later emission copies nothing)."""
    dkey = key + (torch.device(device),)
    if dkey not in _DEVICE_TABLES:
        tv, tvalid = _binary_emit_table(*key)
        _DEVICE_TABLES[dkey] = (torch.from_numpy(tv).to(device),
                                torch.from_numpy(tvalid).to(device))
    return _DEVICE_TABLES[dkey]


def table_emitter(algorithm: str, ambiguity: str = "separate",
                  level: float = 0.5):
    """Emit function for BINARY volumes from the generated table; any
    built-in ambiguity rule or registered tiling name.

    Same ``(volume, cell_idx, *, capacity, cfg_flat=None) → (verts,
    valid)`` contract as ``_emit_triangles`` / ``_emit_triangles_mc``:
    one config byte gathered per cell, then ``table[cfg] + base`` (the
    single f32 add the per-cell path performs), so the output is
    bit-identical to the per-cell emitters.  ``cfg_flat`` is an optional
    precomputed ``cell_configs(volume).reshape(-1)``.  Refuses a level
    whose table is not exact in bfloat16 (only dyadic offsets qualify:
    levels 0 and 0.5), as the JAX package's emitter does.
    """
    if algorithm != "tetrahedra":
        _ensure_tiling(ambiguity)
    key = (algorithm, ambiguity, float(level))
    tv, _ = _binary_emit_table(*key)
    tv_t = torch.from_numpy(tv)
    if not torch.equal(tv_t.to(torch.bfloat16).to(torch.float32), tv_t):
        raise ValueError(
            f"table for level={level} is not bf16-exact; use the per-cell "
            "emitters (levels 0 and 0.5 are dyadic and qualify)"
        )

    def emit(volume, cell_idx, *, capacity, cfg_flat=None):
        ny1, nz1 = volume.shape[1] - 1, volume.shape[2] - 1
        if cfg_flat is None:
            cfg_flat = cell_configs(volume, level=float(level)).reshape(-1)
        tv_d, valid_d = _device_table(key, volume.device)
        idx = cell_idx.long()
        cfg = cfg_flat[idx].long()
        base = torch.stack([idx // (nz1 * ny1), (idx // nz1) % ny1,
                            idx % nz1], dim=-1).to(torch.float32)
        verts = tv_d[cfg] + base[:, None, None, :]
        return verts.reshape(-1, 3, 3), valid_d[cfg].reshape(-1)

    return emit


# ---------------------------------------------------------------------------
# Whole-volume extraction
# ---------------------------------------------------------------------------


def extract_mesh(
    volume,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    capacity: int = 65536,
    algorithm: str = "tetrahedra",
    ambiguity: str = "separate",
    level: float = 0.5,
    emit: str = "auto",
    device="cuda",
):
    """Isosurface mesh of an (nx, ny, nz) volume: a tensor, which stays on
    its device, or a numpy array, which goes to ``device``.

    ``algorithm="tetrahedra"`` (default) — 6-tet decomposition,
    ambiguity-free; ``algorithm="cubes"`` — classic 256-case marching
    cubes (the reference's skimage call, voxel_reconstruction.py:142).
    ``ambiguity`` (cubes only): ``"separate"`` (6-connected inside
    components), ``"join"`` (26-connected, what skimage's Lewiner MC33
    resolves on a binary volume) or a registered tiling.  ``level`` (cubes
    only) places vertices at the linear ``level``-crossing along each cut
    edge; 0.5 is edge midpoints, 0 the reference call's on-corner
    placement.

    Returns (vertices (T, 3, 3) float32 world coords numpy, n_triangles).
    ``capacity`` caps the active cells per device pass; passes repeat
    until all active cells are consumed.

    ``emit``: ``"auto"`` — for a BOOL volume at level 0 or 0.5 the device
    computes the config grid and the host emits from the generated
    256-entry table (``"host_table"`` forces it, raising if ineligible);
    other volumes take the per-cell device pass (``"device"``);
    ``"device_table"`` — device emission from the same table
    (:func:`table_emitter`), raising if ineligible.  All give the same
    triangles.
    """
    if algorithm not in ("tetrahedra", "cubes"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    _ensure_tiling(ambiguity)
    if emit not in ("auto", "device", "host_table", "device_table"):
        raise ValueError(f"unknown emit strategy {emit!r}")
    if algorithm == "tetrahedra" and level != 0.5:
        raise ValueError("level is only supported with algorithm='cubes'")
    if algorithm == "tetrahedra" and ambiguity != "separate":
        raise ValueError(
            "ambiguity is only supported with algorithm='cubes' (the "
            "6-tet decomposition has no ambiguous faces)"
        )
    is_bool = (volume.dtype == torch.bool if isinstance(volume, torch.Tensor)
               else np.dtype(volume.dtype) == np.bool_)
    table_ok = is_bool and float(level) in (0.0, 0.5)
    if emit in ("host_table", "device_table") and not table_ok:
        raise ValueError(
            f"emit={emit!r} needs a bool volume at level 0 or 0.5"
        )
    volume_d = _as_volume(volume, device)
    if table_ok and emit in ("auto", "host_table"):
        return _extract_mesh_table(
            volume_d, origin, spacing, algorithm, ambiguity, float(level)
        )

    if emit == "device_table":
        emit_fn = table_emitter(algorithm, ambiguity, float(level))
        tris_per_cell = 12 if algorithm == "tetrahedra" else _mc_maxt(
            ambiguity)
    elif algorithm == "tetrahedra":
        emit_fn = _emit_triangles
        tris_per_cell = 12
    else:
        def emit_fn(vol, cell_idx, *, capacity):
            return _emit_triangles_mc(vol, cell_idx, capacity=capacity,
                                      ambiguity=ambiguity,
                                      level=float(level))
        tris_per_cell = _mc_maxt(ambiguity)
    # the active cells are found on the host (their number sets the passes)
    active = active_cells_mask(volume_d, level=float(level)).reshape(-1)
    idx = np.flatnonzero(active.cpu().numpy())
    emit_kw = {}
    if emit == "device_table" and len(idx) > capacity:
        # chunked: pay the dense config pass once, not once per chunk
        emit_kw["cfg_flat"] = cell_configs(
            volume_d, level=float(level)).reshape(-1)
    tris_out = []
    for start in range(0, len(idx), capacity):
        chunk = idx[start:start + capacity]
        padded = np.zeros(capacity, np.int64)
        padded[:len(chunk)] = chunk
        verts, valid = emit_fn(
            volume_d, torch.from_numpy(padded).to(volume_d.device),
            capacity=capacity, **emit_kw)
        verts = verts.cpu().numpy()
        valid = valid.cpu().numpy().copy()
        valid[len(chunk) * tris_per_cell:] = False
        tris_out.append(verts[valid])
    if not tris_out:
        return np.zeros((0, 3, 3), np.float32), 0
    tris = np.concatenate(tris_out)
    tris = tris * np.asarray(spacing, np.float32) + np.asarray(origin,
                                                               np.float32)
    return tris.astype(np.float32), len(tris)


def _extract_mesh_table(volume, origin, spacing, algorithm, ambiguity,
                        level):
    """Binary fast path of :func:`extract_mesh`: the config grid on the
    volume's device, emission from the generated 256-entry table on the
    host."""
    tv, tvalid = _binary_emit_table(algorithm, ambiguity, level)
    cfg = cell_configs(volume, level=level).cpu().numpy()
    ny1, nz1 = cfg.shape[1], cfg.shape[2]
    flat = cfg.reshape(-1)
    idx = np.flatnonzero((flat != 0) & (flat != 255))
    if idx.size == 0:
        return np.zeros((0, 3, 3), np.float32), 0
    cfga = flat[idx]
    base = np.stack(
        [idx // (ny1 * nz1), (idx // nz1) % ny1, idx % nz1], axis=-1
    ).astype(np.float32)
    verts = tv[cfga] + base[:, None, None, :]  # (n, T, 3, 3)
    tris = verts.reshape(-1, 3, 3)[tvalid[cfga].reshape(-1)]
    tris = tris * np.asarray(spacing, np.float32) + np.asarray(
        origin, np.float32
    )
    return tris.astype(np.float32), len(tris)


# ---------------------------------------------------------------------------
# Device-resident extraction
# ---------------------------------------------------------------------------

_COMPACT_BLOCK = 128  # cells per block of the block_capacity contract


def _compact_active(active: torch.Tensor, capacity: int,
                    block_capacity: int):
    """Fixed-``capacity`` ascending compaction of a flat bool mask, on
    the mask's device with no wait for the host.

    Each active cell's rank is a cumulative sum; the cells that fit write
    their index into slot ``rank`` of a ``capacity + 1`` buffer, and every
    other cell into its last slot, which is dropped.  So ``idx``
    (capacity,) i32 holds the active cells in ascending order, padded with
    0, like ``np.flatnonzero``.

    ``n_reported`` () i32 is the true active count, except when the active
    cells lie in more than ``block_capacity`` blocks of ``_COMPACT_BLOCK``
    consecutive cells: the JAX package's two-level compaction then keeps
    only the first ``block_capacity`` such blocks, so the count is forced
    above ``capacity`` and the callers redo the frame.  ``idx`` then holds
    those blocks' active cells and 0 after them (the JAX package leaves
    other cells in those slots; every caller discards a truncated result).
    """
    n = active.shape[0]
    dev = active.device
    nblk = -(-n // _COMPACT_BLOCK)
    nb = min(block_capacity, nblk)
    a = torch.cat([active, active.new_zeros(nblk * _COMPACT_BLOCK - n)]
                  ).reshape(nblk, _COMPACT_BLOCK)
    counts = a.sum(1, dtype=torch.int32)
    n_active = counts.sum(dtype=torch.int32)
    blk_on = counts > 0
    blk_rank = torch.cumsum(blk_on, 0, dtype=torch.int32) - 1
    nb_used = blk_on.sum(dtype=torch.int32)
    # cells in the first nb active blocks: the ranks that the JAX package
    # compacts
    kept = torch.where(blk_on & (blk_rank < nb), counts, 0).sum(
        dtype=torch.int32)
    rank = torch.cumsum(active, 0, dtype=torch.int32) - 1
    fits = active & (rank < kept) & (rank < capacity)
    dest = torch.where(fits, rank, capacity).long()
    buf = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    buf.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    idx = buf[:capacity]
    n_reported = torch.where(nb_used > nb,
                             n_active.clamp_min(capacity + 1), n_active)
    return idx, n_reported


def surface_program(
    volume: torch.Tensor,  # (nx, ny, nz) bool/int occupancy
    *,
    algorithm: str = "tetrahedra",
    ambiguity: str = "separate",
    capacity: int = 32768,
    block_capacity: int = 4096,
    device="cuda",
):
    """Surface extraction of a BINARY volume on its device (a numpy volume
    goes to ``device``): config grid
    (:func:`cell_configs`) → fixed-``capacity`` active-cell compaction
    (:func:`_compact_active`) → table emission (:func:`table_emitter`).
    Nothing waits for the host, so calls queue behind each other (the
    frame→mesh step ``VisualHull.process_frame_surface``).

    Returns ``(verts, valid, n_active)``:
      verts    (capacity·T, 3, 3) f32 VOXEL-coordinate triangles
      valid    (capacity·T,) bool  which rows are real triangles
      n_active ()            i32  active cells in the volume — if it
                                  exceeds ``capacity`` (or the active
                                  cells span more than ``block_capacity``
                                  128-cell blocks, in which case the
                                  reported value is forced above
                                  ``capacity``) the result is TRUNCATED
                                  and the caller must redo via
                                  :func:`extract_mesh`.

    World placement is on the host (:func:`world_triangles`), two f32
    numpy roundings, so the result is bit-identical to
    :func:`extract_mesh`; a fused ``v·s + o`` on the device would round
    once and differ by an ulp.
    """
    vol = _as_volume(volume, device).to(torch.bool)
    cfg_flat = cell_configs(vol, level=0.5).reshape(-1).to(torch.int32)
    active = (cfg_flat != 0) & (cfg_flat != 255)
    idx, n_active = _compact_active(active, capacity, block_capacity)
    emit = table_emitter(algorithm, ambiguity, 0.5)
    verts, valid = emit(vol, idx, capacity=capacity, cfg_flat=cfg_flat)
    T = valid.shape[0] // capacity
    # pad slots re-emit cell 0; mask them out by slot rank
    slot_ok = torch.arange(capacity, device=vol.device) < n_active
    valid = valid & slot_ok[:, None].expand(-1, T).reshape(-1)
    return verts, valid, n_active


def surface_wire_program(
    volume: torch.Tensor,  # (nx, ny, nz) bool/int occupancy
    *,
    capacity: int = 32768,
    block_capacity: int = 4096,
    device="cuda",
):
    """Wire-format surface extraction: for a BINARY volume the triangles
    are a pure function of each active cell's (index, 8-bit config), so a
    consumer behind a slow link needs only those: ``(idx (capacity,) i32,
    cfg (capacity,) u8, n_active)`` instead of the emitted triangle
    buffer; the host emits through :func:`triangles_from_wire`.  Same
    truncation contract as :func:`surface_program`."""
    vol = _as_volume(volume, device).to(torch.bool)
    cfg_flat = cell_configs(vol, level=0.5).reshape(-1).to(torch.int32)
    active = (cfg_flat != 0) & (cfg_flat != 255)
    idx, n_active = _compact_active(active, capacity, block_capacity)
    cfg = cfg_flat[idx.long()].to(torch.uint8)
    return idx, cfg, n_active


def triangles_from_wire(idx, cfg, n_active, volume_shape,
                        origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
                        algorithm: str = "cubes", ambiguity: str = "join",
                        level: float = 0.5) -> np.ndarray:
    """Host emission from a :func:`surface_wire_program` result: the
    generated-table math of ``extract_mesh``'s binary fast path, so the
    triangle soup is bit-identical to it.  The native tail
    (``native.mc_emit``) emits; :func:`_triangles_from_wire_numpy` is its
    plain reference."""
    tv, tvalid = _binary_emit_table(algorithm, ambiguity, float(level))
    idx = to_host(idx)
    # a truncated result (n_active > capacity) must not over-read; the
    # callers redo truncated frames via the host path anyway
    n = min(int(n_active), len(idx))
    ny1, nz1 = volume_shape[1] - 1, volume_shape[2] - 1
    if n == 0:
        return np.zeros((0, 3, 3), np.float32)
    T = tv.shape[1]
    return native.mc_emit(idx, to_host(cfg), n, tv.reshape(256, T, 9),
                          tvalid, ny1, nz1, origin, spacing).reshape(-1, 3, 3)


def _triangles_from_wire_numpy(idx, cfg, n, tv, tvalid, ny1, nz1,
                               origin, spacing):
    """numpy tail of :func:`triangles_from_wire`: the native tail's plain
    reference."""
    idx = idx[:n].astype(np.int64)
    cfg = cfg[:n]
    base = np.stack(
        [idx // (ny1 * nz1), (idx // nz1) % ny1, idx % nz1], axis=-1
    ).astype(np.float32)
    verts = tv[cfg] + base[:, None, None, :]
    tris = verts.reshape(-1, 3, 3)[tvalid[cfg].reshape(-1)]
    tris = tris * np.asarray(spacing, np.float32) + np.asarray(
        origin, np.float32
    )
    return tris.astype(np.float32)


def world_triangles(verts, valid, origin, spacing) -> np.ndarray:
    """Filter + world-place a :func:`surface_program` result on the host:
    the same two f32 numpy roundings as :func:`extract_mesh`'s tail, so
    ``world_triangles(*surface_program(v)[:2], o, s)`` is bit-identical to
    ``extract_mesh(v, o, s)``."""
    tris = to_host(verts)[to_host(valid)]
    return (
        tris * np.asarray(spacing, np.float32)
        + np.asarray(origin, np.float32)
    ).astype(np.float32)


def mesh_to_vertex_faces(tris: np.ndarray):
    """Weld identical vertices → (verts (V, 3), faces (T, 3) int32)."""
    flat = tris.reshape(-1, 3)
    verts, inv = np.unique(
        flat.round(decimals=5), axis=0, return_inverse=True
    )
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts, faces


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (V, 3), unit length.

    The cross product of two triangle edges has magnitude 2·area, so
    accumulating raw cross products per vertex IS area weighting — the
    convention of the vertex normals ``skimage.measure.marching_cubes``
    returns (voxel_reconstruction.py:142).  The triangles are outward
    wound, so the result points outward.
    """
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )  # (T, 3), |fn| = 2*area
    vn = np.zeros_like(verts, dtype=np.float64)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def write_obj(path: str, tris: np.ndarray, normals: bool = True):
    """Dump a triangle soup as a Wavefront OBJ.

    ``normals=True`` welds vertices, computes area-weighted vertex
    normals, and writes ``vn`` records with ``f a//a`` faces.
    """
    verts, faces = mesh_to_vertex_faces(tris)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        if normals:
            for n in vertex_normals(verts, faces):
                f.write(f"vn {n[0]:.5f} {n[1]:.5f} {n[2]:.5f}\n")
            for a, b, c in faces + 1:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
        else:
            for a, b, c in faces + 1:
                f.write(f"f {a} {b} {c}\n")
