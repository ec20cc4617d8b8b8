"""The port's sharded layer (``vbr_tpu_torch/parallel``) against
``vbr_tpu/parallel`` on the CPU.

``vbr_tpu`` runs on the conftest's 8-device CPU mesh with its Pallas
kernels in interpret mode, as tests/test_parallel_pallas.py runs it, on
that file's small rig (64×96 images, synthetic cameras, 32³, superblocks
(1,1,1) and (2,2,4)).  The port runs in spawned gloo ranks, one process per
shard (``test_torch_parallel_ranks.py``, which imports neither JAX nor
``vbr_tpu``): 2, 3 and 4 ranks, started once for the whole module, joined
with a deadline and killed past it.  The placement half needs no process
group and runs here.

Every comparison is exact: occupancy, colours, overflow flags, superblock
orders, costs and triangles bit for bit.  The only inexact route is
``ry``/``rx``, which the port keeps in f32 and ``vbr_tpu`` in bf16: they
are compared as values.
"""

import functools
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_parallel_ranks as R
from vbr_tpu.ops import carve as j_carve
from vbr_tpu.ops import carve_pallas as j_cp
from vbr_tpu.ops import ccl as j_ccl
from vbr_tpu.ops import color as j_color
from vbr_tpu.ops import gmm as j_gmm
from vbr_tpu.ops import morphology as j_morph
from vbr_tpu.parallel import carve_sharded as j_cs
from vbr_tpu.parallel import mesh_sharded as j_ms
from vbr_tpu.parallel import pallas_sharded as j_ps
from vbr_tpu.parallel import pipeline_sharded as j_pipe
from vbr_tpu.utils import config as j_config
from vbr_tpu.utils import synthetic as j_syn
from vbr_tpu_torch.ops import carve_blocked
from vbr_tpu_torch.parallel import carve_sharded, pallas_sharded
from vbr_tpu_torch.utils.synthetic import synthetic_cameras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3, 4)
DEADLINE_S = 300  # for all spawned ranks together
H, W, C = R.H, R.W, R.C


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ranks:
    """The spawned ranks of every world, started at once; their results
    are read (waiting, up to the deadline) on first use."""

    def __init__(self, workdir):
        self.workdir = workdir
        with open(os.path.join(workdir, "cases.json"), "w") as f:
            json.dump(R.cases(), f)
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        script = os.path.join(ROOT, "tests", "test_torch_parallel_ranks.py")
        self.procs = [
            subprocess.Popen(
                [sys.executable, script, str(workdir), str(rank),
                 str(world)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for world in WORLDS for rank in range(world)]
        self.start = time.monotonic()
        self._results = None

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def results(self):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    left = DEADLINE_S - (time.monotonic() - self.start)
                    out, _ = p.communicate(timeout=max(left, 1))
                    logs.append(out)
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"spawned ranks still running after "
                            f"{DEADLINE_S} s; killed")
            bad = [(p.args[-2:], log) for p, log in zip(self.procs, logs)
                   if p.returncode != 0]
            assert not bad, bad[0]
            self._results = {
                w: [dict(np.load(os.path.join(self.workdir,
                                              f"w{w}_rank{r}.npz")))
                    for r in range(w)]
                for w in WORLDS}
        return self._results

    def __getitem__(self, cid):
        world = next(w for w, c, _ in R.cases() if c == cid)
        res = self.results()[world][0]
        return {k.split("/", 1)[1]: v for k, v in res.items()
                if k.startswith(cid + "/")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.kill()


def _cases(kind):
    return [pytest.param(spec, id=cid) for _, cid, spec in R.cases()
            if spec["kind"] in kind]


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------


def _jgrid(n=32):
    return j_config.GridConfig(nx=n, ny=n, nz=n, **R.GRID_BOUNDS)


def _jcams():
    return j_syn.synthetic_cameras(C, image_hw=(H, W), f=80.0)


@functools.lru_cache(maxsize=None)
def _jtables(sup):
    return j_cp.build_block_tables(_jcams(), _jgrid(), (H, W), sub=(8, 8, 8),
                                   sup=sup, color_camera=1)


@functools.lru_cache(maxsize=None)
def _ptables(sup):
    return carve_blocked.build_block_tables(
        synthetic_cameras(C, image_hw=(H, W), f=80.0), R.grid(), (H, W),
        sub=(8, 8, 8), sup=sup, color_camera=1, device="cpu")


def _jmesh(shape, names=("data", "cam", "grid")):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _jfz(fz):
    return j_gmm.FrozenMOGState(*(jnp.asarray(a) for a in fz))


def _jmasks(fz, frame_one, mask_params):
    """vbr_tpu's single-chip mask stage of one frame (interpret mode)."""
    hsv = jnp.stack([j_color.bgr_to_hsv_u8(jnp.asarray(frame_one[c]))
                     for c in range(C)])
    raws = []
    for c in range(C):
        raw = j_gmm.apply_frozen_compressed(
            j_gmm.FrozenMOGState(mean=fz.mean[c], thr=fz.thr[c],
                                 bcount=fz.bcount[c]), hsv[c])
        mp = mask_params[c]
        if mp.opening_pre:
            raw = j_morph.opening(raw, (3, 3))
        if mp.closing_pre:
            raw = j_morph.closing(raw, (3, 3))
        raws.append(raw)
    cleaned, _ = j_ccl.clean_masks_batched(jnp.stack(raws), R.FIG_THR,
                                           R.INNER_THR, interpret=True)
    ms = []
    for c in range(C):
        m, mp = cleaned[c], mask_params[c]
        if mp.opening_post:
            m = j_morph.opening(m, (2, 2))
        if mp.closing_post:
            m = j_morph.closing(m, (2, 2))
        ms.append(jnp.where(m > 0, jnp.uint8(255), jnp.uint8(0)))
    return np.asarray(jnp.stack(ms))


@functools.lru_cache(maxsize=None)
def _jprogram(shape, sup, frames_n):
    """vbr_tpu's sharded step on ``shape`` with its placed inputs, built
    once and run for every order."""
    mesh = _jmesh(shape)
    btab = _jtables(sup)
    fz_np, frames = R.production_scene(frames_n)
    fz = _jfz(fz_np)
    mp = j_config.DEFAULT_MASK_PARAMS[:C]
    st = j_ps.shard_block_tables(mesh, btab)
    step = j_ps.sharded_production_step(mesh, st.local_static, use_hsv=True,
                                        views_threshold=4, interpret=True)
    placed = j_ps.place_production_inputs(
        mesh, frames, fz, R.FIG_THR, R.INNER_THR, j_ps.mask_flags_array(mp))
    masks0 = _jmasks(fz, frames[0], mp)
    return mesh, btab, step, placed, masks0


# ---------------------------------------------------------------------------
# Spawned ranks against vbr_tpu
# ---------------------------------------------------------------------------


def test_every_rank_returns_the_whole_result(ranks):
    for world, per_rank in ranks.results().items():
        assert per_rank[0], f"no results at {world} ranks"
        for other in per_rank[1:]:
            assert other.keys() == per_rank[0].keys()
            for k, v in per_rank[0].items():
                assert np.array_equal(other[k], v), (world, k)


@pytest.mark.parametrize("spec", _cases(("production",)))
def test_sharded_production_step_bitwise(ranks, spec):
    """Occupancy, colours and overflow in slot order, and the order, equal
    to vbr_tpu's at the same mesh shape; (1,1,3) pads nsuper 4 to 6."""
    shape, sup, order_mode = tuple(spec["shape"]), tuple(spec["sup"]), \
        spec["order"]
    mesh, btab, step, placed, masks0 = _jprogram(shape, sup,
                                                 spec["frames_n"])
    S = shape[1] * shape[2]
    order = None
    if order_mode is not None:
        costs = (j_ps.superblock_costs(btab, masks0, views_threshold=4)
                 if order_mode == "cost" else None)
        order = j_ps.superblock_order(btab.nsuper, S, order_mode, costs=costs)
    st = j_ps.shard_block_tables(mesh, btab, order=order)
    occ_b, col_b, ovf = (np.asarray(x) for x in step(
        *placed, st.pk, st.lcc, st.vorig, st.uorig, st.allv, st.ry, st.rx))
    got = ranks[f"prod_{'x'.join(map(str, shape))}_{order_mode}"]
    assert int(got["nsuper_pad"]) == st.nsuper_pad
    if order is not None:
        np.testing.assert_array_equal(got["order"], order)
    np.testing.assert_array_equal(got["occ_b"], occ_b)
    np.testing.assert_array_equal(got["col_b"], col_b)
    np.testing.assert_array_equal(got["ovf"], ovf)
    assert occ_b.any() and not ovf.any()
    if st.nsuper_pad > btab.nsuper:  # the pad slots came out empty
        inv = np.argsort(st.order if st.order is not None
                         else np.arange(st.nsuper_pad))
        pad_slots = inv[btab.nsuper:]
        assert not got["occ_b"][:, pad_slots].any()
        assert not got["col_b"][:, pad_slots].any()


def _jmodel():
    from vbr_tpu.models.visual_hull import VisualHull as JVisualHull

    (weight, mean, var), batches = R.runner_scene()
    mp = tuple(
        j_config.MaskParams(**{f: getattr(p, f) for f in (
            "figure_threshold", "inner_threshold", "opening_pre",
            "closing_pre", "opening_post", "closing_post")})
        for p in R.runner_mask_params())
    model = JVisualHull(_jcams(), _jgrid(),
                        j_config.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    model.bg_states = [
        j_gmm.MOGState(weight=jnp.asarray(weight[c]),
                       mean=jnp.asarray(mean[c]), var=jnp.asarray(var[c]),
                       nframes=jnp.asarray(6, jnp.int32))
        for c in range(C)]
    model.mog_params = [j_config.MOGParams()] * C
    return model, batches


@functools.lru_cache(maxsize=None)
def _jrunner_outputs(order):
    model, batches = _jmodel()
    mesh = j_cs.make_carve_mesh(4, num_cameras=2, frame_batch=2)
    run = model.sharded_runner(
        mesh, order=order,
        costing_frames=batches[0][0] if order == "cost" else None,
        interpret=True)
    return run.order, [run(b) for b in batches]


@pytest.mark.parametrize("order", ["strided", "cost"])
def test_runner_call_and_stream_match(ranks, order):
    """``ShardedRunner.__call__`` and ``stream(depth=2)`` over four 2-frame
    batches at (2,2,1), the last with a frame whose cleanup overflows
    (redone through the host cleanup on every rank), equal to vbr_tpu's
    runner."""
    want_order, want = _jrunner_outputs(order)
    got = ranks[f"runner_{order}"]
    np.testing.assert_array_equal(got["order"], want_order)
    for i, (occ, col) in enumerate(want):
        for how in ("call", "stream"):
            np.testing.assert_array_equal(got[f"{how}{i}_occ"], occ)
            np.testing.assert_array_equal(got[f"{how}{i}_col"], col)
    assert bool(got["short_batch_refused"])
    assert not np.array_equal(want[0][0], want[2][0])


def test_runner_overflow_frame_is_exercised():
    """The fourth batch's second frame overflows the device tables in the
    port (so the runner test above covers the redo)."""
    model, batches = R.port_model()
    _, _, ovf = model._step(torch.from_numpy(batches[3][1]),
                            model._carve_kernel("blocked"), "blocked")
    assert bool(ovf.any())


def test_runner_rebalance_decides_as_vbr_tpu(ranks):
    """A contiguous placement re-costed from the live frame: the decision,
    the costs, the new order, the predicted loads and the outputs before
    and after equal vbr_tpu's; the automatic hook then keeps the order."""
    model, batches = _jmodel()
    mesh = j_cs.make_carve_mesh(4, num_cameras=2, frame_batch=2)
    runner = model.sharded_runner(mesh, order="contiguous", interpret=True,
                                  rebalance_every=1)
    occ_a, col_a = runner(batches[0])
    replaced = runner.rebalance(batches[0][0], min_gain=0.0)
    got = ranks["runner_rebalance"]
    assert replaced and bool(got["replaced"])
    assert bool(got["mode_cost"]) and runner.mode == "cost"
    np.testing.assert_array_equal(got["costs"], runner.costs)
    np.testing.assert_array_equal(got["order"], runner.order)
    assert float(got["imbalance"]) == runner.imbalance()
    np.testing.assert_array_equal(got["shard_costs"], runner.shard_costs())
    occ_b, col_b = runner(batches[0])
    np.testing.assert_array_equal(got["order_after"], runner.order)
    for k, v in (("occ_a", occ_a), ("col_a", col_a), ("occ_b", occ_b),
                 ("col_b", col_b)):
        np.testing.assert_array_equal(got[k], v)


@functools.lru_cache(maxsize=None)
def _jtable_carve():
    return j_carve.build_projection_tables(_jcams(), _jgrid(16), (H, W))


@pytest.mark.parametrize("spec", _cases(("carve", "pipeline",
                                         "pipeline_clean")))
def test_sharded_table_steps_bitwise(ranks, spec):
    """``sharded_carve_step`` (occupancy and colours) and
    ``sharded_pipeline_step`` (clean off and on) equal vbr_tpu's."""
    shape, kind = tuple(spec["shape"]), spec["kind"]
    mesh = _jmesh(shape)
    t = _jtable_carve()
    masks, images, (frames, weight, mean, var) = R.table_scene()
    got = ranks[f"{kind}_{'x'.join(map(str, shape))}"]
    if kind == "carve":
        step = j_cs.sharded_carve_step(mesh, views_threshold=4,
                                       color_camera=1)
        occ, col = step(*j_cs.shard_inputs(mesh, masks, images, t.valid,
                                           t.lin_idx))
        np.testing.assert_array_equal(got["col"], np.asarray(col))
    else:
        clean = kind == "pipeline_clean"
        p = j_config.MOGParams(use_hsv=False, n_mixtures=4)
        step = j_pipe.sharded_pipeline_step(mesh, views_threshold=3,
                                            mog_params=p, clean=clean)
        thr = (dict(fig_thr=np.asarray(R.PIPE_FIG),
                    inner_thr=np.asarray(R.PIPE_INNER)) if clean else {})
        occ = step(*j_pipe.place_pipeline_inputs(
            mesh, frames, weight, mean, var, t.valid, t.lin_idx, **thr))
    occ = np.asarray(occ)
    np.testing.assert_array_equal(got["occ"], occ)
    assert 0 < occ.sum() < occ.size


@pytest.mark.parametrize("spec,world", [
    pytest.param(spec, int(cid[4]), id=cid) for _, cid, spec in R.cases()
    if spec["kind"] == "mesh"])
def test_extract_mesh_sharded_bitwise(ranks, spec, world):
    """Triangles of ``extract_mesh_sharded`` (and the active cells of
    ``sharded_active_cells``) at 2 and 3 ranks equal vbr_tpu's on a
    ``grid`` mesh of as many devices: tetrahedra, cubes, a
    per-shard capacity of 8 (the retry), scaled coordinates, a float field
    (the per-cell emitters) and an x-size the ranks do not divide (the
    single-device fallback)."""
    vol, kw = R.volume_scene(spec["volume"])
    mesh = _jmesh((world,), ("grid",))
    tris, n = j_ms.extract_mesh_sharded(vol, mesh, **kw)
    got = ranks[f"mesh{world}_{spec['volume']}"]
    assert int(got["n"]) == n > 0
    np.testing.assert_array_equal(got["tris"], tris)
    if vol.shape[0] % world == 0:  # the halo pass alone, gathered
        act = j_ms.sharded_active_cells(mesh)(jax.device_put(
            vol, NamedSharding(mesh, P("grid", None, None))))
        np.testing.assert_array_equal(got["act"], np.asarray(act))
        assert got["act"].any()
    else:
        assert "act" not in got


# ---------------------------------------------------------------------------
# Placement, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nsuper,nshards,mode", [
    (64, 8, "contiguous"), (64, 8, "strided"), (4, 3, "strided"),
    (10, 4, "cost"), (64, 5, "cost"), (64, 8, "cost")])
def test_superblock_order_matches(nsuper, nshards, mode):
    rng = np.random.default_rng(nsuper * nshards)
    costs = rng.random(nsuper) ** 3 if mode == "cost" else None
    np.testing.assert_array_equal(
        pallas_sharded.superblock_order(nsuper, nshards, mode, costs=costs),
        j_ps.superblock_order(nsuper, nshards, mode, costs=costs))


@pytest.mark.parametrize("kw", [dict(mode="cost"),
                                dict(mode="cost", costs=-np.ones(8)),
                                dict(mode="nope")])
def test_superblock_order_refuses_as_vbr_tpu(kw):
    for pkg in (pallas_sharded, j_ps):
        with pytest.raises(ValueError):
            pkg.superblock_order(8, 4, **kw)


def test_mask_flags_array_matches():
    from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS

    np.testing.assert_array_equal(
        pallas_sharded.mask_flags_array(DEFAULT_MASK_PARAMS),
        j_ps.mask_flags_array(j_config.DEFAULT_MASK_PARAMS))


@functools.lru_cache(maxsize=None)
def _masks0():
    fz, frames = R.production_scene(1)
    return _jmasks(_jfz(fz), frames[0], j_config.DEFAULT_MASK_PARAMS[:C])


@pytest.mark.parametrize("sup", [(1, 1, 1), (2, 2, 4)])
def test_superblock_costs_match(sup):
    want = j_ps.superblock_costs(_jtables(sup), _masks0(), views_threshold=4)
    got = pallas_sharded.superblock_costs(_ptables(sup), _masks0(), 4)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0.02  # some superblock is active


SLICE_CASES = [((1, 1, 1), 8, None), ((2, 2, 4), 3, None),
               ((1, 1, 1), 8, "strided"), ((1, 1, 1), 5, "cost")]


def _order(sup, nshards, mode):
    if mode is None:
        return None
    costs = (j_ps.superblock_costs(_jtables(sup), _masks0(), 4)
             if mode == "cost" else None)
    return j_ps.superblock_order(_jtables(sup).nsuper, nshards, mode,
                                 costs=costs)


@pytest.mark.parametrize("sup,nshards,mode", SLICE_CASES)
def test_local_table_slice_matches(sup, nshards, mode):
    """Every shard's slice equal to vbr_tpu's, field by field (ry/rx as
    values: f32 here, bf16 there)."""
    order = _order(sup, nshards, mode)
    for k in range(nshards):
        got = pallas_sharded.local_table_slice(_ptables(sup), k, nshards,
                                               order=order)
        want = j_ps.local_table_slice(_jtables(sup), k, nshards, order=order)
        assert got.nsuper == want.nsuper
        for f in ("pk", "lcc", "vorig", "uorig", "allv", "ry", "rx"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(want, f)).astype(
                    getattr(got, f).numpy().dtype), err_msg=f)
        np.testing.assert_array_equal(got.perm, want.perm)


@pytest.mark.parametrize("sup,nshards,mode", SLICE_CASES)
def test_local_table_slice_union_is_exact(sup, nshards, mode):
    """The shards' carves on their slices (K1's plain version) tile the
    whole carve: their union, unshuffled, equals it bit for bit."""
    tables = _ptables(sup)
    masks = torch.from_numpy(_masks0())
    _, frames = R.production_scene(1)
    image = torch.from_numpy(frames[0][1])
    occ_full, col_full = carve_blocked.carve_blocked(
        masks, image, tables, views_threshold=4, layout="blocked")
    order = _order(sup, nshards, mode)
    parts = [carve_blocked.carve_blocked(
        masks, image, pallas_sharded.local_table_slice(tables, k, nshards,
                                                       order=order),
        views_threshold=4, layout="blocked") for k in range(nshards)]
    occ_u = torch.cat([o for o, _ in parts])[None]
    col_u = torch.cat([c for _, c in parts])[None]
    occ_u, col_u = pallas_sharded.unshuffle_blocked(occ_u, col_u, tables,
                                                    order)
    assert torch.equal(occ_u[0], occ_full) and torch.equal(col_u[0], col_full)
    assert int(occ_full.sum()) > 0


def test_pad_blocks_are_inert():
    """nsuper 4 over 3 shards: the 2 pad rows have allv 0, zero spans,
    colour column and perm −1, no activity, and carve to zeros."""
    tables = _ptables((2, 2, 4))
    masks = torch.full((C, H, W), 255, dtype=torch.uint8)  # all foreground
    image = torch.full((H, W, 3), 7, dtype=torch.uint8)
    loc = pallas_sharded.local_table_slice(tables, 2, 3)  # slots 4, 5: pad
    assert loc.nsuper == 2 and (loc.perm == -1).all()
    assert not loc.allv.any() and not loc.ry.any() and not loc.rx.any()
    assert (loc.lcc == -1).all()
    active, full = carve_blocked.block_activity(masks, 4, loc.allv, loc.ry,
                                                loc.rx)
    assert not active.any() and not full.any()
    occ, col = carve_blocked.carve_blocked(masks, image, loc,
                                           views_threshold=4,
                                           layout="blocked")
    assert not occ.any() and not col.any()


def test_unshuffle_blocked_matches():
    rng = np.random.default_rng(2)
    tables = _ptables((2, 2, 4))
    order = j_ps.superblock_order(tables.nsuper, 3, "strided")
    occ = rng.integers(0, 2, (2, 6, 16, 8), dtype=np.uint8)
    col = rng.integers(0, 256, (2, 6, 16, 3, 8), dtype=np.uint8)
    for o in (None, order):
        want = j_ps.unshuffle_blocked(occ, col, _jtables((2, 2, 4)), o)
        for x in ((occ, col), (torch.from_numpy(occ), torch.from_numpy(col))):
            got = pallas_sharded.unshuffle_blocked(*x, tables, o)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), w)


def test_mesh_needs_a_process_group():
    """Without an initialised default group both mesh functions raise;
    nothing quietly runs on one device."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        carve_sharded.make_carve_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        carve_sharded.carve_mesh((1, 1, 1), "cpu")


def test_runner_validates_inputs():
    """No blocked tables (a grid not divisible by 8·sup) and a cost order
    without a costing frame raise ``ValueError``, as in vbr_tpu."""
    from vbr_tpu_torch.utils.config import GridConfig

    mesh = SimpleNamespace(device_type="cpu", shape=(1, 1, 1),
                           mesh_dim_names=carve_sharded.MESH_DIMS)
    model, _ = R.port_model()
    with pytest.raises(ValueError, match="costing_frames"):
        model.sharded_runner(mesh, order="cost")
    model, _ = R.port_model()
    model.grid = GridConfig(nx=20, ny=20, nz=20, **R.GRID_BOUNDS)
    with pytest.raises(ValueError, match="divisible"):
        model.sharded_runner(mesh)
