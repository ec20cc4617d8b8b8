"""Port parity of the large-grid path: the device table builds
(``carve.build_projection_tables(accelerate=True)``,
``carve.exact_truncated_projections``,
``carve_blocked.build_block_tables_device`` and the auto-choice of
``build_block_tables``), the device build's f64 spot check, the table-free
``carve.carve_fused`` and ``Reconstructor(use_tables=False)``.

The device builds run here on the CPU (the same torch code as on the card)
and must equal the float64 host builds of both packages bit for bit, on
four camera sets at 32³ and 64³: the ``auto_extrinsics`` rig, the
synthetic rig, the calibration poses of ``artifacts/intrinsics_run`` (35-80
% of the grid in view, strong distortion, voxels far off axis) and a rig
whose camera 0 stands inside the grid, so its principal plane crosses it.
``carve_fused`` is exact against ``vbr_tpu`` run op by op under
``jax.disable_jit()``; against the jitted build, which contracts
multiply-adds, at most 0.01 % of voxels may differ, each within 1e-3 px of
a pixel or image boundary."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.ops import carve as jcarve
from vbr_tpu.ops import carve_pallas as jcp
from vbr_tpu.pipelines import reconstruction as jrec
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import camera as tcam
from vbr_tpu_torch.ops import carve as tcarve
from vbr_tpu_torch.ops import carve_blocked as tcb
from vbr_tpu_torch.ops.color import bgr_to_hsv_u8
from vbr_tpu_torch.ops.gmm import MOGState
from vbr_tpu_torch.pipelines import reconstruction as trec
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import synthetic as tsyn
from vbr_tpu_torch.utils import xmlio as txml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (486, 644)  # the image size every camera set here is calibrated at
RIGS = ("auto_extrinsics", "synthetic", "intrinsics_run", "principal_plane")
SIZES = (32, 64)
TABLE_FIELDS = ("pk", "lcc", "vorig", "uorig", "allv", "ry", "rx")


def _t(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cameras(name):
    """(port cameras, vbr_tpu cameras) of one camera set, equal numbers."""
    if name == "synthetic":
        return tsyn.synthetic_cameras(4), jsyn.synthetic_cameras(4)
    if name == "principal_plane":
        cams = tsyn.synthetic_cameras(4)
        R, t = tsyn.look_at_rt(np.array([200.0, 100.0, -700.0]),
                               np.array([900.0, 600.0, -300.0]))
        cams[0] = tconfig.CameraParams.from_arrays(
            cams[0].K, cams[0].dist, tcam.rodrigues_inverse(R), t)
    else:
        cams = []
        for i in range(1, 5):
            art = os.path.join(ROOT, "artifacts", name)
            d, f = ((art, f"cam{i}_config.xml") if name == "auto_extrinsics"
                    else (os.path.join(art, f"cam{i}"), "config.xml"))
            cams.append(tconfig.CameraParams.from_arrays(
                *txml.load_camera_config(d, f)))
    return cams, [jconfig.CameraParams.from_arrays(c.K, c.dist, c.rvec, c.tvec)
                  for c in cams]


def _grids(n):
    return tconfig.GridConfig(nx=n, ny=n, nz=n), jconfig.GridConfig(nx=n, ny=n,
                                                                    nz=n)


@pytest.fixture(scope="module")
def oracle():
    """Memoised references per (camera set, grid edge): the f64 host
    builds of both packages and ``vbr_tpu``'s device builds."""
    memo = {}

    def get(name, n, what):
        key = (name, n, what)
        if key not in memo:
            (tc, jc), (tg, jg) = _cameras(name), _grids(n)
            memo[key] = {
                "port_blocks": lambda: tcb.build_block_tables(
                    tc, tg, HW, accelerate=False, device="cpu"),
                "jax_blocks": lambda: jcp.build_block_tables(
                    jc, jg, HW, accelerate=False),
                "jax_blocks_device": lambda: jcp.build_block_tables_device(
                    jc, jg, HW),
                "port_tables": lambda: tcarve.build_projection_tables(
                    tc, tg, HW, accelerate=False, device="cpu"),
                "jax_tables": lambda: jcarve._build_tables_f64(jc, jg, HW),
            }[what]()
        return memo[key]

    return get


def _assert_block_tables_equal(got, want):
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(
            _t(getattr(got, name)),
            np.asarray(getattr(want, name), dtype=np.float32)
            if name in ("ry", "rx") else _t(getattr(want, name)),
            err_msg=name)
    assert (got.WH, got.WC, got.Hp, got.Wc) == (want.WH, want.WC, want.Hp,
                                                want.Wc)
    assert got.n_fcells_hw == want.n_fcells_hw
    np.testing.assert_array_equal(got.perm, want.perm)


# -- the device builds against the f64 oracles ------------------------------


@pytest.mark.parametrize("chunk", [1 << 24, 4096], ids=["one_chunk", "folds"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("rig", RIGS)
def test_block_tables_device_match_f64(oracle, rig, n, chunk):
    cams, _ = _cameras(rig)
    got = tcb.build_block_tables_device(cams, _grids(n)[0], HW,
                                        chunk_voxels=chunk, device="cpu")
    _assert_block_tables_equal(got, oracle(rig, n, "port_blocks"))
    _assert_block_tables_equal(got, oracle(rig, n, "jax_blocks"))
    assert got.pk.dtype == torch.int32 and got.ry.dtype == torch.float32


@pytest.mark.parametrize("rig", RIGS)
def test_block_tables_device_match_the_reference_device_build(oracle, rig):
    """At 32³, where ``vbr_tpu``'s device build holds on every camera set
    (it keeps a fixed 2e-3 px band and misses index flips on the
    calibration poses from 64³ on: the next test)."""
    cams, _ = _cameras(rig)
    got = tcb.build_block_tables_device(cams, _grids(32)[0], HW,
                                        chunk_voxels=4096, device="cpu")
    _assert_block_tables_equal(got, oracle(rig, 32, "jax_blocks_device"))


def test_reference_device_build_misses_the_distortion_fold(oracle):
    """``vbr_tpu``'s device build differs from its own f64 build on the
    calibration poses at 64³, at voxels far off the optical axis whose
    distorted projection folds back into the image (f32 error above its
    2e-3 px band); the port's equals the f64 build there
    (test_block_tables_device_match_f64)."""
    cams, _ = _cameras("intrinsics_run")
    grid = _grids(64)[0]
    ref = oracle("intrinsics_run", 64, "jax_blocks_device")
    want = oracle("intrinsics_run", 64, "jax_blocks")
    bad = np.argwhere(np.asarray(ref.pk) != np.asarray(want.pk))
    assert len(bad) >= 1
    pts = grid.voxel_points()
    for so, sb, c, sl in bad:
        cp = cams[c]
        X = tcam.rodrigues(cp.rvec) @ pts[want.perm[so, sb, sl]] + cp.tvec
        assert (X[0] ** 2 + X[1] ** 2) / X[2] ** 2 > 2.0  # r² of the fold


@pytest.mark.parametrize("n", SIZES)
def test_principal_plane_band_is_not_empty(n):
    """Camera 0 of the principal-plane rig has voxels within _SUS_Z_EPS of
    its principal plane; each is suspicious (rechecked in f64)."""
    cams, _ = _cameras("principal_plane")
    grid = _grids(n)[0]
    cp = cams[0]
    depth = (grid.voxel_points() @ tcam.rodrigues(cp.rvec)[2] + cp.tvec[2])
    near = np.abs(depth) < tcarve._SUS_Z_EPS
    assert near.sum() > 0
    xs, ys, zs = (torch.from_numpy(a.astype(np.float32))
                  for a in grid.axis_ranges())
    sus = tcarve._proj_suspicion_chunk(xs, ys, zs,
                                       *tcarve._camera_f32(cp, "cpu"), HW)[3]
    assert bool(sus.numpy()[near].all())


@pytest.mark.parametrize("slabs", ["one", "many"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("rig", RIGS)
def test_projection_tables_device_match(oracle, monkeypatch, rig, n, slabs):
    if slabs == "many":  # a few x-planes per slab
        monkeypatch.setattr(tcarve, "CHUNK_VOXELS", 4 * n * n)
    cams, jcams = _cameras(rig)
    got = tcarve.build_projection_tables(cams, _grids(n)[0], HW,
                                         device="cpu")
    for want in (oracle(rig, n, "port_tables"), oracle(rig, n, "jax_tables")):
        np.testing.assert_array_equal(_t(got.valid), _t(want.valid))
        np.testing.assert_array_equal(_t(got.lin_idx), _t(want.lin_idx))
    assert got.image_hw == HW and got.lin_idx.dtype == torch.int32


@pytest.mark.parametrize("rig", RIGS)
def test_projection_tables_match_the_reference_device_build(rig):
    cams, jcams = _cameras(rig)
    tg, jg = _grids(32)
    got = tcarve.build_projection_tables(cams, tg, HW, device="cpu")
    want = jcarve.build_projection_tables(jcams, jg, HW, accelerate=True)
    np.testing.assert_array_equal(_t(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_t(got.lin_idx), np.asarray(want.lin_idx))


@pytest.mark.parametrize("rig", RIGS)
def test_exact_truncated_projections_match(oracle, rig):
    """Per camera: equal to the f64 tables of both packages at 64³, and to
    ``vbr_tpu``'s own accelerated function at 32³ (one compile each)."""
    cams, jcams = _cameras(rig)
    W = HW[1]
    tables = oracle(rig, 64, "port_tables")
    for c, cp in enumerate(cams):
        iy, ix, valid = tcarve.exact_truncated_projections(
            cp, _grids(64)[0], HW, device="cpu")
        assert iy.dtype == ix.dtype == np.int64 and valid.dtype == bool
        np.testing.assert_array_equal(valid, _t(tables.valid[c]))
        np.testing.assert_array_equal(np.where(valid, iy * W + ix, 0),
                                      _t(tables.lin_idx[c]))
    got = tcarve.exact_truncated_projections(cams[1], _grids(32)[0], HW,
                                             device="cpu")
    want = jcarve.exact_truncated_projections(jcams[1], _grids(32)[1], HW)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("entry", [
    "build_projection_tables", "exact_truncated_projections",
    "build_block_tables", "build_block_tables_device", "fused_reconstructor"])
def test_table_builds_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cams, _ = _cameras("synthetic")
    grid = _grids(32)[0]
    call = {
        "build_projection_tables": lambda: tcarve.build_projection_tables(
            cams, grid, HW),
        "exact_truncated_projections":
            lambda: tcarve.exact_truncated_projections(cams[0], grid, HW),
        "build_block_tables": lambda: tcb.build_block_tables(cams, grid, HW),
        "build_block_tables_device":
            lambda: tcb.build_block_tables_device(cams, grid, HW),
        "fused_reconstructor": lambda: trec.Reconstructor(
            cams, grid, use_tables=False),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_synthetic_rig_takes_eight_cameras():
    """The 8-camera rig of the 512³ carve: the frames' third channel wraps
    past 255 as the JAX package's u8 cast did (newer numpy refuses a Python
    integer out of range), and equals the JAX package's four-camera rig."""
    cams, masks, frames = tsyn.synthetic_rig(num_cameras=8)
    assert len(cams) == 8 and masks.shape == (8,) + HW
    assert frames[:, 0, 0, 2].tolist() == [60, 90, 120, 150, 180, 210, 240,
                                           14]
    for a, b in zip(tsyn.synthetic_rig()[1:], jsyn.synthetic_rig()[1:]):
        np.testing.assert_array_equal(a, b)


# -- the auto-choice and the spot check -------------------------------------


@pytest.mark.parametrize("shape,accelerate,want", [
    ((256, 256, 256), None, "device"),  # 2^24 voxels
    ((256, 256, 248), None, "host"),
    ((32, 32, 32), None, "host"),
    ((32, 32, 32), True, "device"),
    ((256, 256, 256), False, "host"),
])
def test_auto_choice_picks_the_device_build_from_2_24_voxels(
        monkeypatch, shape, accelerate, want):
    calls = []
    for name, side in (("build_block_tables_device", "device"),
                       ("_build_block_tables_f64", "host")):
        monkeypatch.setattr(tcb, name,
                            lambda *a, side=side, **k: calls.append(side))
    grid = tconfig.GridConfig(nx=shape[0], ny=shape[1], nz=shape[2])
    tcb.build_block_tables(tsyn.synthetic_cameras(4), grid, HW,
                           accelerate=accelerate, device="cpu")
    assert calls == [want]


def test_spot_check_raises_on_a_corrupted_word():
    cams, _ = _cameras("auto_extrinsics")
    grid = _grids(32)[0]
    tab = tcb.build_block_tables_device(cams, grid, HW, device="cpu")
    tcb._spot_check(tab.pk, tab.perm, cams, grid, HW)  # the build holds
    rng = np.random.default_rng(0)  # the sample the check draws
    at = [rng.integers(0, n, tcb.SPOT_CHECK_VOXELS)
          for n in (tab.nsuper, tab.nsub, tcb.BV)]
    pk = tab.pk.clone()
    pk[at[0][7], at[1][7], 2, at[2][7]] ^= 1  # one word, one bit
    with pytest.raises(AssertionError,
                       match=r"spot check: camera 2, \d+/2048"):
        tcb._spot_check(pk, tab.perm, cams, grid, HW)


# -- a model whose blocked tables are built on the device -------------------

MH, MW, K = 64, 96, 50
MGRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
             y_max=950, z_min=-1700, z_max=300)


def _model():
    """A CPU model of the small synthetic rig with seeded MOG states and
    one frame of a sphere painted over the background."""
    rng = np.random.default_rng(9)
    cams = tsyn.synthetic_cameras(4, image_hw=(MH, MW), f=80.0)
    bg = rng.integers(40, 200, size=(4, MH, MW, 3), dtype=np.uint8)
    mp = [dataclasses.replace(p, figure_threshold=40.0, inner_threshold=8.0)
          for p in tconfig.DEFAULT_MASK_PARAMS]
    m = tvh.VisualHull(cams, tconfig.GridConfig(**MGRID),
                       tconfig.RigConfig(image_height=MH, image_width=MW),
                       mask_params=mp, device="cpu")
    hsv = bgr_to_hsv_u8(torch.from_numpy(bg)).numpy().astype(np.float32)
    states = []
    for c in range(4):
        w = np.zeros((MH, MW, K), np.float32)
        w[..., 0] = 1.0
        mean = np.zeros((MH, MW, K, 3), np.float32)
        mean[..., 0, :] = hsv[c]
        var = np.zeros((MH, MW, K), np.float32)
        var[..., 0] = 200.0
        states.append(MOGState(*(torch.from_numpy(a) for a in (w, mean, var)),
                               nframes=torch.tensor(40, dtype=torch.int32)))
    m.bg_states = states
    m.mog_params = [tconfig.MOGParams()] * 4
    frame = bg.copy()
    for c, cp in enumerate(cams):
        sil = tsyn.sphere_silhouette_mask(cp, np.array([60.0, -40.0, -650.0]),
                                          520.0, (MH, MW)) > 0
        frame[c][sil] = (30, 220, 250)
    return m, frame


def test_model_builds_its_blocked_tables_on_the_device(monkeypatch):
    """Past the auto-choice's threshold the model's fast step runs on the
    device-built tables, and equals the step on the host-built ones."""
    host, frame = _model()
    want = host.process_frame_fast(frame)
    monkeypatch.setattr(tcb, "DEVICE_BUILD_VOXELS", 0)
    built = []
    real = tcb.build_block_tables_device
    monkeypatch.setattr(tcb, "build_block_tables_device",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    dev, _ = _model()
    got = dev.process_frame_fast(frame)
    assert built == [1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < int(got[0].sum()) < got[0].numel()


def test_spot_check_error_gets_out_of_process_frame_fast(monkeypatch):
    """A device build whose words are wrong (here every valid column moved
    by one, which no suspicion band flags) fails its spot check, and the
    ``AssertionError`` leaves ``process_frame_fast``: the model does not
    fall back to the table step (``_btab`` stays unbuilt, not None)."""
    real = tcb._exact_slabs

    def corrupted(*a, **k):
        for x0, iy, ix, valid in real(*a, **k):
            yield x0, iy, torch.where(valid & (ix > 0), ix - 1, ix), valid

    monkeypatch.setattr(tcb, "DEVICE_BUILD_VOXELS", 0)
    monkeypatch.setattr(tcb, "_exact_slabs", corrupted)
    m, frame = _model()
    with pytest.raises(AssertionError, match="f64 spot check"):
        m.process_frame_fast(frame)
    assert m._btab is tvh._UNBUILT


# -- the fused carve ---------------------------------------------------------

FUSED_RIGS = ("auto_extrinsics", "synthetic")


@pytest.fixture(scope="module")
def fused_inputs():
    """Per camera set at 64³: sphere silhouettes with 3 % speckle, random
    BGR frames, and the fused carve of both packages (the port's, ``vbr_tpu``
    jitted and op by op)."""
    out = {}
    rng = np.random.default_rng(17)
    for rig in FUSED_RIGS:
        cams, jcams = _cameras(rig)
        tg, jg = _grids(64)
        masks = np.stack([tsyn.sphere_silhouette_mask(
            cp, np.array([200.0, 0.0, -900.0]), 600.0, HW) for cp in cams])
        speckle = rng.random(masks.shape) < 0.03
        masks = np.where(speckle, 255 - masks, masks).astype(np.uint8)
        frames = rng.integers(0, 256, size=(4,) + HW + (3,), dtype=np.uint8)
        got = tcarve.carve_fused(
            torch.from_numpy(masks), torch.from_numpy(frames),
            tcarve.voxel_points_f32(tg, "cpu"),
            *tcarve._pose_arrays(cams, "cpu"), image_hw=HW)
        jargs = (jnp.asarray(masks), jnp.asarray(frames),
                 jnp.asarray(jg.voxel_points(), dtype=jnp.float32),
                 *jcarve._pose_arrays(jcams))
        with jax.disable_jit():
            eager = jcarve.carve_fused(*jargs, image_hw=HW)
        jitted = jcarve.carve_fused(*jargs, image_hw=HW)
        out[rig] = dict(cams=cams, grid=tg, masks=masks, frames=frames,
                        got=got, eager=eager, jitted=jitted)
    return out


@pytest.mark.parametrize("rig", FUSED_RIGS)
def test_carve_fused_bit_equal_to_reference_without_jit(fused_inputs, rig):
    f = fused_inputs[rig]
    for a, b in zip(f["got"], f["eager"]):
        np.testing.assert_array_equal(_t(a), np.asarray(b))
    assert 0 < int(f["got"][0].sum()) < f["got"][0].numel()


def _boundary_px(cams, grid, idx):
    """(len(idx), C) f64 distance of each voxel's projection to the nearest
    pixel or image boundary, per camera."""
    pts = grid.voxel_points()[idx]
    out = []
    for cp in cams:
        uv = tcam.project_points(pts, cp.rvec, cp.tvec, cp.K, cp.dist)
        frac = np.abs(uv - np.round(uv))  # pixel edges are the integers
        out.append(frac.min(axis=1))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("rig", FUSED_RIGS)
def test_carve_fused_within_tolerance_of_jitted_reference(fused_inputs, rig):
    """XLA:CPU may contract the jitted projection into multiply-adds: at
    most 0.01 % of voxels may differ (occupancy or colour), and each such
    voxel projects within 1e-3 px of a pixel edge (the image's edges are
    pixel edges too) in some camera (the colour camera for a colour)."""
    f = fused_inputs[rig]
    occ, col = (_t(a) for a in f["got"])
    jocc, jcol = (np.asarray(a) for a in f["jitted"])
    d_occ = np.flatnonzero(occ != jocc)
    d_col = np.flatnonzero((col != jcol).any(axis=1))
    n = occ.size
    print(f"{rig}: {len(d_occ)} occupancy and {len(d_col)} colour voxels of "
          f"{n} differ from the jitted reference")
    assert len(np.union1d(d_occ, d_col)) <= 1e-4 * n
    if len(d_occ):
        assert (_boundary_px(f["cams"], f["grid"], d_occ).min(axis=1)
                < 1e-3).all()
    if len(d_col):
        assert (_boundary_px(f["cams"], f["grid"], d_col)[:, 1] < 1e-3).all()


@pytest.mark.parametrize("rig", FUSED_RIGS)
def test_carve_fused_agrees_with_the_table_path(oracle, fused_inputs, rig):
    f = fused_inputs[rig]
    tables = oracle(rig, 64, "port_tables")
    occ_t, col_t = tcarve.carve_from_tables(
        torch.from_numpy(f["masks"]), torch.from_numpy(f["frames"]),
        tables.valid, tables.lin_idx)
    occ = f["got"][0]
    differ = int((occ != occ_t).sum())
    assert differ <= 1e-4 * occ.numel()
    both = (occ & occ_t).numpy()
    same_col = (f["got"][1].numpy() == col_t.numpy()).all(axis=1)
    assert same_col[both].mean() >= 0.9999


def test_reconstructor_without_tables_matches_reference():
    """``Reconstructor(use_tables=False)`` on the rig at 64³ equals
    ``vbr_tpu``'s op by op, and agrees with the table path."""
    cams, jcams = _cameras("auto_extrinsics")
    tg, jg = _grids(64)
    rig_t = tconfig.RigConfig()
    masks = np.stack([tsyn.sphere_silhouette_mask(
        cp, np.array([0.0, 100.0, -800.0]), 650.0, HW) for cp in cams])
    frames = np.random.default_rng(4).integers(0, 256, (4,) + HW + (3,),
                                               dtype=np.uint8)
    rt = trec.Reconstructor(cams, tg, rig_t, use_tables=False, device="cpu")
    assert rt.tables is None
    rj = jrec.Reconstructor(jcams, jg, jconfig.RigConfig(), use_tables=False)
    occ, col = rt.carve_frame(masks, frames)
    with jax.disable_jit():
        jocc, jcol = rj.carve_frame(masks, frames)
        jpos, jrgb = rj.carve_frame_compact(masks, frames)
    np.testing.assert_array_equal(_t(occ), np.asarray(jocc))
    np.testing.assert_array_equal(_t(col), np.asarray(jcol))
    for a, b in zip(rt.carve_frame_compact(masks, frames), (jpos, jrgb)):
        np.testing.assert_array_equal(a, b)
    occ_tab, _ = trec.Reconstructor(cams, tg, rig_t,
                                    device="cpu").carve_frame(masks, frames)
    assert int((occ != occ_tab).sum()) <= 1e-4 * occ.numel()
    assert 0 < int(occ.sum())
