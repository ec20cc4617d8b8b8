"""Port parity of the surface path: ``vbr_tpu_torch/ops/marching_cubes.py``
and the frame→mesh entry points of ``VisualHull`` against ``vbr_tpu`` on
the same seeded inputs.

Every comparison is exact (``assert_array_equal``), with one exception: a
float volume at a non-dyadic level (0.3) through the per-cell cubes
emitter.  There the port rounds ``pa + t·(pb − pa)`` after each operation,
as ``vbr_tpu`` does op by op under ``jax.disable_jit()`` (held exactly);
the jitted ``vbr_tpu`` build may let XLA:CPU contract the multiply-add into
one fused operation (the same constraint ROADMAP.md records for MOG
training), which rounds once, so against it the vertices may differ by
one rounding of the interpolated coordinate: at most 2 ulp of the largest
voxel coordinate, with the same triangles valid.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.ops import marching_cubes as jmc
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops import marching_cubes as tmc
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import synthetic as tsyn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAIRS = [("tetrahedra", "separate"), ("cubes", "separate"),
         ("cubes", "join")]
ORIGIN = (-512.0, -1024.0, -2048.0)
SPACING = (12.0, 16.0, 20.0)


def _random_volume(seed, shape=(12, 10, 14), p=0.35):
    return np.random.default_rng(seed).uniform(size=shape) < p


def _kept(active, block_capacity):
    """How many of a flat bool mask's active cells the first
    ``block_capacity`` active 128-cell blocks hold (the cells a truncated
    compaction keeps)."""
    pad = (-len(active)) % 128
    counts = np.concatenate([active, np.zeros(pad, bool)]).reshape(
        -1, 128).sum(1)
    return int(counts[counts > 0][:block_capacity].sum())


def _three_cubes():
    """Three isolated cubes far apart along x: their active cells lie in
    at least three 128-cell blocks, and number at most 128."""
    vol = np.zeros((40, 8, 8), bool)
    for x0 in (2, 16, 30):
        vol[x0:x0 + 2, 2:4, 2:4] = True
    return vol


# -- tables ------------------------------------------------------------------


@pytest.mark.parametrize("ambig", ["separate", "join"])
def test_generated_tables_match(ambig):
    tj, mj = jmc._build_mc_tables(ambig)
    tt, mt = tmc._build_mc_tables(ambig)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(tmc._MC_EDGE_CORNERS_NP,
                                  jmc._MC_EDGE_CORNERS_NP)


@pytest.mark.parametrize("level", [0.0, 0.5])
@pytest.mark.parametrize("algorithm,ambiguity", PAIRS)
def test_binary_emit_table_matches(algorithm, ambiguity, level):
    """The table is built by running each package's own per-cell emitters
    on the 256 synthetic cells; the two must agree bit for bit."""
    vj, okj = jmc._binary_emit_table(algorithm, ambiguity, level)
    vt, okt = tmc._binary_emit_table(algorithm, ambiguity, level)
    assert vt.dtype == vj.dtype == np.float32
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(okt, okj)


@pytest.mark.parametrize("level", [0.0, 0.3, 0.5])
def test_cell_configs_and_active_mask(level):
    rng = np.random.default_rng(4)
    for vol in (_random_volume(1), rng.uniform(size=(9, 11, 7)).astype(
            np.float32)):
        np.testing.assert_array_equal(
            tmc.cell_configs(torch.from_numpy(vol), level).numpy(),
            np.asarray(jmc.cell_configs(jnp.asarray(vol), level=level)))
        np.testing.assert_array_equal(
            tmc.active_cells_mask(torch.from_numpy(vol), level).numpy(),
            np.asarray(jmc.active_cells_mask(jnp.asarray(vol), level=level)))


# -- whole-volume extraction -------------------------------------------------


@pytest.mark.parametrize("emit", ["auto", "device", "host_table",
                                  "device_table"])
@pytest.mark.parametrize("algorithm,ambiguity", PAIRS)
def test_extract_mesh_matches(algorithm, ambiguity, emit):
    """Every emission strategy, with origin and spacing; a capacity of 256
    cells takes the device modes through several passes."""
    vol = _random_volume(3)
    kw = dict(origin=ORIGIN, spacing=SPACING, capacity=256,
              algorithm=algorithm, ambiguity=ambiguity, emit=emit)
    want, n_want = jmc.extract_mesh(vol, **kw)
    got, n_got = tmc.extract_mesh(vol, device="cpu", **kw)
    assert n_got == n_want > 0 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # a tensor input stays on its device and gives the same soup
    got_t, _ = tmc.extract_mesh(torch.from_numpy(vol), **kw)
    np.testing.assert_array_equal(got_t, want)


def test_float_volume_at_a_non_dyadic_level():
    """``emit="device"`` on a float field at level 0.3: exact against the
    JAX package run op by op; against its jitted build the tolerance of
    the module docstring."""
    vol = np.random.default_rng(8).uniform(size=(9, 8, 10)).astype(
        np.float32)
    kw = dict(origin=ORIGIN, spacing=SPACING, capacity=512,
              algorithm="cubes", ambiguity="join", level=0.3, emit="device")
    got, n_got = tmc.extract_mesh(vol, device="cpu", **kw)
    with jax.disable_jit():
        want, n_want = jmc.extract_mesh(vol, **kw)
    assert n_got == n_want > 0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="bool volume"):
        tmc.extract_mesh(vol, device="cpu", **{**kw, "emit": "host_table"})
    # the per-cell emitter in voxel coordinates against the jitted build
    cells = np.flatnonzero(np.asarray(jmc.active_cells_mask(vol, level=0.3)))
    vj, okj = jmc._emit_triangles_mc(jnp.asarray(vol), jnp.asarray(cells),
                                     capacity=len(cells), ambiguity="join",
                                     level=0.3)
    vt, okt = tmc._emit_triangles_mc(torch.from_numpy(vol),
                                     torch.from_numpy(cells),
                                     capacity=len(cells), ambiguity="join",
                                     level=0.3)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ulp = np.spacing(np.float32(max(vol.shape)))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=2 * ulp)


def test_non_dyadic_table_refused_like_the_reference():
    with pytest.raises(ValueError, match="bf16-exact"):
        jmc.table_emitter("cubes", "join", 0.3)
    with pytest.raises(ValueError, match="bf16-exact"):
        tmc.table_emitter("cubes", "join", 0.3)


# -- device-resident extraction ----------------------------------------------


@pytest.mark.parametrize("case", ["sparse", "over capacity",
                                  "over block_capacity"])
def test_compact_active_matches(case):
    """``idx`` and ``n_reported`` equal, pad slots included; past a
    block-capacity truncation the port pads with 0 where the JAX package
    leaves other cells (a truncated result is always redone)."""
    rng = np.random.default_rng(len(case))
    n = 5000
    p, cap, bc = {"sparse": (0.01, 4096, 4096),
                  "over capacity": (0.2, 300, 4096),
                  "over block_capacity": (0.05, 4096, 7)}[case]
    a = rng.uniform(size=n) < p
    want_idx, want_n = jmc._compact_active(jnp.asarray(a), cap, bc)
    got_idx, got_n = tmc._compact_active(torch.from_numpy(a), cap, bc)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (cap,)
    kept = min(_kept(a, bc), cap)
    assert kept > 0
    np.testing.assert_array_equal(got_idx.numpy()[:kept],
                                  np.asarray(want_idx)[:kept])
    if case == "over block_capacity":
        assert kept < a.sum() and not got_idx.numpy()[kept:].any()
    else:
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert int(got_n) == int(want_n)
    if case.startswith("over"):
        assert int(got_n) > cap  # the callers redo this frame


@pytest.mark.parametrize("kind", ["random", "empty", "full", "three cubes"])
@pytest.mark.parametrize("algorithm,ambiguity", PAIRS)
def test_surface_programs_match(algorithm, ambiguity, kind):
    """Raw outputs of ``surface_program`` and ``surface_wire_program``
    (pad slots included; for the three cubes, truncated by the block
    limit, the slots the compaction keeps), then ``world_triangles`` and
    ``triangles_from_wire``, all equal to the JAX package's and to its
    ``extract_mesh``."""
    vol = {"random": _random_volume(9), "empty": np.zeros((6, 6, 6), bool),
           "full": np.ones((6, 6, 6), bool),
           "three cubes": _three_cubes()}[kind]
    kw = dict(capacity=2048, block_capacity=2 if kind == "three cubes"
              else 4096)
    want = jmc.surface_program(vol, algorithm=algorithm,
                               ambiguity=ambiguity, **kw)
    got = tmc.surface_program(torch.from_numpy(vol), algorithm=algorithm,
                              ambiguity=ambiguity, **kw)
    # slots compared: all, or those a block-limit truncation keeps
    slots = (_kept(np.asarray(jmc.active_cells_mask(vol)).reshape(-1), 2)
             if kind == "three cubes" else kw["capacity"])
    T = got[1].shape[0] // kw["capacity"]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[:slots * T],
                                      np.asarray(w)[:slots * T])
    assert int(got[2]) == int(want[2])
    wire_j = jmc.surface_wire_program(vol, **kw)
    wire_t = tmc.surface_wire_program(torch.from_numpy(vol), **kw)
    for g, w in zip(wire_t[:2], wire_j[:2]):
        assert g.dtype == {np.int32: torch.int32, np.uint8: torch.uint8}[
            np.asarray(w).dtype.type]
        np.testing.assert_array_equal(g.numpy()[:slots],
                                      np.asarray(w)[:slots])
    assert int(wire_t[2]) == int(wire_j[2])
    if kind == "three cubes":
        assert 0 < slots < int(jmc.active_cells_mask(vol).sum())
        assert int(got[2]) > kw["capacity"]  # forced: the callers redo
        return
    ref, n_ref = jmc.extract_mesh(vol, ORIGIN, SPACING, algorithm=algorithm,
                                  ambiguity=ambiguity)
    tris = tmc.world_triangles(got[0], got[1], ORIGIN, SPACING)
    tris_w = tmc.triangles_from_wire(*wire_t, vol.shape, ORIGIN, SPACING,
                                     algorithm=algorithm,
                                     ambiguity=ambiguity)
    assert len(tris) == len(tris_w) == n_ref
    assert (n_ref > 0) == (kind == "random")
    np.testing.assert_array_equal(tris, ref)
    np.testing.assert_array_equal(tris_w, ref)
    np.testing.assert_array_equal(tris_w, jmc._triangles_from_wire_numpy(
        np.asarray(wire_j[0]), np.asarray(wire_j[1]), int(wire_j[2]),
        *jmc._binary_emit_table(algorithm, ambiguity, 0.5),
        vol.shape[1] - 1, vol.shape[2] - 1, ORIGIN, SPACING))


# -- the tiling registry -----------------------------------------------------


def _port_oracle(vol, level):
    """A per-cell 'external implementation' in the oracle contract: the
    port's own join-rule emitter."""
    verts, valid = tmc._emit_triangles_mc(
        torch.from_numpy(vol), torch.zeros(1, dtype=torch.int64),
        capacity=1, ambiguity="join", level=float(level))
    tris = verts.numpy()[valid.numpy()]
    uniq, inv = np.unique(tris.reshape(-1, 3).round(6), axis=0,
                          return_inverse=True)
    return uniq, inv.reshape(-1, 3)


@pytest.fixture(scope="module")
def derived_table():
    return tmc.derive_tiling_from_oracle(_port_oracle, level=0.25)


def test_registered_tiling_gives_equal_meshes(derived_table):
    """The table derived through the port's oracle path, registered under
    one unique name in both packages: same meshes in both, through the
    host table and the device programs."""
    name = "portparity_tiling"
    jmc.register_tiling(name, derived_table)
    tmc.register_tiling(name, derived_table)
    try:
        assert name in tmc.known_ambiguities()
        vol = _random_volume(5, shape=(10, 9, 11))
        want, n_want = jmc.extract_mesh(vol, algorithm="cubes",
                                        ambiguity=name)
        got, n_got = tmc.extract_mesh(vol, algorithm="cubes",
                                      ambiguity=name, device="cpu")
        assert n_got == n_want > 0
        np.testing.assert_array_equal(got, want)
        sj = jmc.surface_program(vol, algorithm="cubes", ambiguity=name,
                                 capacity=2048)
        st = tmc.surface_program(torch.from_numpy(vol), algorithm="cubes",
                                 ambiguity=name, capacity=2048)
        for g, w in zip(st, sj):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            tmc.world_triangles(st[0], st[1], (0, 0, 0), (1, 1, 1)), got)
    finally:
        jmc._MC_TABLES_J.pop(name, None)
        jmc._MC_MAXTS.pop(name, None)
        tmc._MC_TABLES.pop(name, None)


def _bad(derived_table, what):
    if what == "non-cut edge":
        bad = derived_table.copy()
        row = bad[1][bad[1, :, 0] >= 0][0]
        bad[1, 0, 0] = next(e for e in range(12) if e not in set(row))
        return "badtable", bad
    if what == "256":
        return "badshape", np.zeros((16, 2, 3), np.int32)
    if what == "carry no":
        bad = derived_table.copy()
        bad[1] = -1  # config 1 cuts three edges and emits nothing
        return "badcover", bad
    return "join", derived_table  # "built-in"


@pytest.mark.parametrize("what", ["non-cut edge", "256", "carry no",
                                  "built-in"])
def test_bad_tables_raise_in_both(derived_table, what):
    name, table = _bad(derived_table, what)
    for mc in (jmc, tmc):
        with pytest.raises(ValueError, match=what):
            mc.register_tiling(name, table)
    assert name == "join" or name not in tmc.known_ambiguities()


def test_unregistered_mc33_raises_in_both():
    vol = np.zeros((4, 4, 4), bool)
    with pytest.raises(ValueError, match="derive_mc33_tiling"):
        jmc.extract_mesh(vol, algorithm="cubes", ambiguity="mc33")
    with pytest.raises(ValueError, match="derive_mc33_tiling"):
        tmc.extract_mesh(vol, algorithm="cubes", ambiguity="mc33",
                         device="cpu")
    with pytest.raises(ValueError, match="unknown ambiguity"):
        tmc.surface_program(torch.from_numpy(vol), algorithm="cubes",
                            ambiguity="nosuchrule")


def test_derived_table_recovers_the_join_tiling(derived_table):
    def tri_sets(table, cfg):
        rows = table[cfg][table[cfg, :, 0] >= 0]
        return {tuple(sorted(map(int, r))) for r in rows}

    for cfg in range(256):
        assert tri_sets(derived_table, cfg) == tri_sets(
            jmc._MC_TABLE_JOIN_NP, cfg), cfg


# -- host helpers ------------------------------------------------------------


@pytest.mark.parametrize("normals", [True, False])
def test_mesh_helpers_and_obj_match(tmp_path, normals):
    tris, _ = jmc.extract_mesh(_random_volume(2), ORIGIN, SPACING,
                               algorithm="cubes", ambiguity="join")
    vj, fj = jmc.mesh_to_vertex_faces(tris)
    vt, ft = tmc.mesh_to_vertex_faces(tris)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(tmc.vertex_normals(vt, ft),
                                  jmc.vertex_normals(vj, fj))
    jmc.write_obj(str(tmp_path / "j" / "hull.obj"), tris, normals=normals)
    tmc.write_obj(str(tmp_path / "t" / "hull.obj"), tris, normals=normals)
    assert (tmp_path / "t" / "hull.obj").read_bytes() == (
        tmp_path / "j" / "hull.obj").read_bytes()


# -- VisualHull: the frame→mesh step -----------------------------------------

H, W, C, K = 64, 96, 4, 50
GRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)
FG_BGR = np.array([30, 220, 250], np.uint8)
CAP = 4096


def _frame(rng, bg, cams, center, radius=520.0):
    """Background + painted sphere silhouettes + a few speckles."""
    fr = bg.copy()
    for c, cp in enumerate(cams):
        sil = tsyn.sphere_silhouette_mask(cp, np.asarray(center), radius,
                                          (H, W)) > 0
        fr[c][sil] = FG_BGR
        ys, xs = rng.integers(0, H, 15), rng.integers(0, W, 15)
        fr[c, ys, xs] = FG_BGR
    return fr


def _models(grid_kw):
    """One seeded rig and MOG state in both packages."""
    rng = np.random.default_rng(5)
    bg = rng.integers(40, 200, size=(C, H, W, 3), dtype=np.uint8)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    states = []
    for c in range(C):
        w = np.zeros((H, W, K), np.float32)
        w[..., :3] = rng.dirichlet([6.0, 3.0, 1.0], size=(H, W))
        mean = np.zeros((H, W, K, 3), np.float32)
        mean[..., :3, :] = (bg_hsv[c][:, :, None, :].astype(np.float32)
                            + rng.normal(0, 3, (H, W, 3, 3)))
        var = np.zeros((H, W, K), np.float32)
        var[..., :3] = rng.uniform(150.0, 600.0, (H, W, 3))
        states.append(jgmm.MOGState(weight=jnp.asarray(w),
                                    mean=jnp.asarray(mean),
                                    var=jnp.asarray(var),
                                    nframes=jnp.int32(40)))
    mp = [dataclasses.replace(p, figure_threshold=40.0, inner_threshold=8.0)
          for p in jconfig.DEFAULT_MASK_PARAMS]
    cams = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        jconfig.GridConfig(**grid_kw),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    mj.bg_states = states
    mj.mog_params = [jconfig.MOGParams()] * C
    mt = tvh.VisualHull(cams, tconfig.GridConfig(**grid_kw),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in mp],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s, "cpu") for s in states]
    mt.mog_params = [tconfig.MOGParams()] * C
    frames = [_frame(rng, bg, cams, (60.0 + 60 * i, -40.0 + 30 * i, -650.0))
              for i in range(3)]
    return mj, mt, frames


@pytest.fixture(scope="module")
def models():
    return _models(GRID)


@pytest.fixture(scope="module")
def jax_surfaces(models):
    """``vbr_tpu``'s ``process_frame_surface`` on every frame, both pairs
    (computed once: each static configuration compiles a program)."""
    mj, _, frames = models
    return {pair: [mj.process_frame_surface(fr, *pair, capacity=CAP)
                   for fr in frames]
            for pair in [("cubes", "join"), ("tetrahedra", "separate")]}


def _same_frame(got, want):
    tris, occ, col = got
    tris_j, occ_j, col_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    # colours off the hull differ by path (the blocked carve leaves 0)
    np.testing.assert_array_equal(col.numpy()[occ_j], col_j[occ_j])
    assert tris.dtype == np.float32 and len(tris) > 0
    np.testing.assert_array_equal(tris, tris_j)


@pytest.mark.parametrize("pair", [("cubes", "join"),
                                  ("tetrahedra", "separate")])
def test_process_frame_surface_matches(models, jax_surfaces, pair):
    _, mt, frames = models
    for fr, want in zip(frames, jax_surfaces[pair]):
        _same_frame(mt.process_frame_surface(fr, *pair, capacity=CAP), want)


def test_full_step_surface_raw_outputs_match(models):
    """The port's step on the blocked tables with ``surface_program``
    behind it against ``vbr_tpu``'s ``_full_step_surface`` with its Pallas
    kernels interpreted: all six outputs bit-equal, colours and pad slots
    included."""
    mj, mt, frames = models
    mj._ensure_fast_state()
    mj._ensure_btab()
    jmc.table_emitter("cubes", "join", 0.5)
    b = mj._btab
    want = jvh._full_step_surface(
        mj._stacked_fz, jnp.asarray(frames[0]), b.pk, b.lcc, b.vorig,
        b.uorig, b.allv, b.ry, b.rx, btab_static=jvh._btab_static(b),
        mask_params=mj._mask_params_t, use_hsv=True,
        fig_thresholds=mj._fig_thresholds,
        inner_thresholds=mj._inner_thresholds,
        views_threshold=mj.rig.views_threshold, grid_shape=mj.grid.shape,
        algorithm="cubes", ambiguity="join", capacity=CAP, interpret=True)
    occ, col, ovf = mt._step(torch.from_numpy(frames[0]),
                             mt._carve_kernel("auto"))
    assert mt._btab is not None
    got = (*tmc.surface_program(occ.reshape(mt.grid.shape), algorithm="cubes",
                                ambiguity="join", capacity=CAP),
           occ, col, ovf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_capacity_redo_and_extract_surface_match(models, jax_surfaces):
    """More active cells than ``capacity``: ``extract_mesh`` meshes the
    step's occupancy, with the same triangles, occupancy and colours on the
    hull as ``vbr_tpu``'s host redo; ``extract_surface`` equals both
    packages' ``process_frame_surface``."""
    mj, mt, frames = models
    want = jax_surfaces[("cubes", "join")][1]
    _same_frame(mt.process_frame_surface(frames[1], capacity=8), want)
    tris, n = mt.extract_surface(frames[1])
    tris_j, n_j = mj.extract_surface(frames[1])
    assert n == n_j == len(want[0])
    np.testing.assert_array_equal(tris, tris_j)
    np.testing.assert_array_equal(tris, np.asarray(want[0]))


def test_component_overflow_redone_on_the_table_path(models):
    """A frame whose speckle overflows the device component tables is
    redone on the plain table path, as in ``vbr_tpu``: triangles,
    occupancy and every colour equal; both streams give the same."""
    mj, mt, frames = models
    frame = frames[0].copy()
    frame[:, ::3, ::3] = FG_BGR  # more isolated components than the tables
    assert bool(mt._step(torch.from_numpy(frame),
                         mt._carve_kernel("auto"))[2].any())
    want = mj.process_frame_surface(frame, capacity=CAP)
    got = mt.process_frame_surface(frame, capacity=CAP)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w))
    for transfer in ("full", "wire"):
        (tris, occ), = mt.stream_surface(iter([frame]), capacity=CAP,
                                         transfer=transfer)
        occ = occ.numpy() if isinstance(occ, torch.Tensor) else occ
        np.testing.assert_array_equal(tris, np.asarray(want[0]))
        np.testing.assert_array_equal(occ, np.asarray(want[1]))


@pytest.mark.parametrize("transfer", ["full", "wire"])
def test_stream_surface_matches(models, jax_surfaces, transfer):
    _, mt, frames = models
    out = list(mt.stream_surface(iter(frames), depth=2, capacity=CAP,
                                 transfer=transfer))
    assert len(out) == len(frames)
    for (tris, occ), want in zip(out, jax_surfaces[("cubes", "join")]):
        occ = occ.numpy() if isinstance(occ, torch.Tensor) else occ
        np.testing.assert_array_equal(occ, np.asarray(want[1]))
        np.testing.assert_array_equal(tris, np.asarray(want[0]))
    assert not np.array_equal(out[0][0], out[2][0])


def test_surface_wire_matches(models):
    """The one-buffer wire: the port's bytes equal ``vbr_tpu``'s on the
    same occupancy and overflow bits, and decode to the same arrays."""
    mj, mt, frames = models
    occ = mt.process_frame_fast(frames[2])[0]
    ovf = torch.tensor([False, True, False, False])
    want = np.asarray(jvh._encode_surface_wire(
        jnp.asarray(occ.numpy()), jnp.asarray(ovf.numpy()), mj.grid.shape,
        CAP))
    got = tvh._encode_surface_wire(occ, ovf, mt.grid.shape, CAP)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    for g, w in zip(tvh._decode_surface_wire(got, CAP, mt.grid.num_voxels),
                    jvh._decode_surface_wire(want, CAP, mj.grid.num_voxels)):
        np.testing.assert_array_equal(g, w)


def test_stream_surface_refuses_what_is_not_ported(models):
    """Unknown transfers and ingest formats raise; the reduced-byte ingest
    formats run (``tests/test_torch_ingest.py`` holds them to
    ``vbr_tpu``)."""
    _, mt, frames = models
    for ingest in ("yuv420", "yuv420_roi"):
        tris, occ = next(mt.stream_surface(iter(frames), ingest=ingest,
                                           roi_hw=(48, 64)))
        assert tris.dtype == np.float32 and occ.shape == (mt.grid.num_voxels,)
    with pytest.raises(ValueError, match="transfer"):
        next(mt.stream_surface(iter(frames), transfer="zip"))
    with pytest.raises(ValueError, match="ingest"):
        next(mt.stream_surface(iter(frames), ingest="rgb"))


def test_surface_on_a_grid_not_divisible():
    """A 20×16×16 grid has no blocked tables: the table step, with the
    same triangles, occupancy and colours as ``vbr_tpu``; the wire stream
    too."""
    grid = dict(GRID, nx=20, ny=16, nz=16)
    mj, mt, frames = _models(grid)
    want = mj.process_frame_surface(frames[0], capacity=CAP)
    got = mt.process_frame_surface(frames[0], capacity=CAP)
    assert mt._ensure_btab() is None
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w))
    (tris, occ), = mt.stream_surface(iter(frames[:1]), capacity=CAP,
                                     transfer="wire")
    np.testing.assert_array_equal(tris, np.asarray(want[0]))
    np.testing.assert_array_equal(occ, np.asarray(want[1]))


@pytest.mark.parametrize("fn", ["surface_program", "surface_wire_program",
                                "cell_configs", "active_cells_mask"])
def test_numpy_volume_defaults_to_the_card(fn):
    """A numpy volume goes to the card unless the caller asks for the CPU:
    without one it raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vol = _random_volume(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tmc, fn)(vol)
    got = getattr(tmc, fn)(vol, device="cpu")
    want = getattr(tmc, fn)(torch.from_numpy(vol))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "cpu" and torch.equal(g, w)


def test_viewer_arrays_match(models):
    mj, mt, frames = models
    for g, w in zip(mt.viewer_arrays(frames[0]), mj.viewer_arrays(frames[0])):
        np.testing.assert_array_equal(g, np.asarray(w))

