"""Port parity of the viewer seam: rig XML, the reconstruction helpers, the
projection-table cache and ``assignment_api``, against ``vbr_tpu`` on the
shipped rig files and on the synthetic rig.  Every comparison is exact:
the f64 camera math runs the same numpy operations in the same order in
both packages, so camera positions and rotations are equal numbers."""

import dataclasses
import glob
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.apps import assignment_api as japi
from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.pipelines import reconstruction as jrec
from vbr_tpu.utils import artifacts as jart
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu.utils import xmlio as jxml
from vbr_tpu_torch.apps import assignment_api as tapi
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.pipelines import reconstruction as trec
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import synthetic as tsyn
from vbr_tpu_torch.utils import xmlio as txml
from vbr_tpu_torch.utils.video import ArraySource


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG_XML = os.path.join(ROOT, "artifacts", "auto_extrinsics")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "artifacts", "**", "*config*.xml"), recursive=True))


def _rig_dir(tmp_path):
    """The auto_extrinsics rig as a data directory: cam{i}/config.xml."""
    for i in range(1, 5):
        os.makedirs(tmp_path / f"cam{i}")
        shutil.copy(os.path.join(RIG_XML, f"cam{i}_config.xml"),
                    tmp_path / f"cam{i}" / "config.xml")
    return str(tmp_path)


# -- xmlio ----------------------------------------------------------------


def test_shipped_configs_are_the_rig_and_the_calibration_runs():
    assert len(CONFIGS) >= 8
    assert all(f"auto_extrinsics/cam{i}_config.xml" in " ".join(CONFIGS)
               and f"intrinsics_run/cam{i}/config.xml" in " ".join(CONFIGS)
               for i in range(1, 5))


@pytest.mark.parametrize("path", CONFIGS)
def test_config_arrays_match(path):
    d, name = os.path.split(os.path.join(ROOT, path))
    got = txml.load_camera_config(d, name)
    want = jxml.load_camera_config(d, name)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert txml.load_storage(os.path.join(d, name)).keys() == \
        jxml.load_storage(os.path.join(d, name)).keys()


def _tricky_nodes():
    rng = np.random.default_rng(2)
    return {
        "Ints": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "Bytes": rng.integers(0, 256, (2, 5)).astype(np.uint8),
        "Shorts": np.array([[-7, 300]], np.int16),
        "Floats": rng.normal(size=(4, 3)).astype(np.float32),
        "Doubles": np.array([[0.0, -0.0, 1.0, -12.0, 1e16, 1e-300, np.pi,
                              2.5e15, -1.25e-7, 123456789.0]]),
        "Channels": rng.normal(size=(2, 2, 3)),
        "Vector": rng.normal(size=7),
        "Width": 8, "Size": 115.0, "Name": "board",
    }


def test_save_storage_bytes_identical_and_cross_read(tmp_path):
    nodes = _tricky_nodes()
    txml.save_storage(str(tmp_path / "t.xml"), nodes)
    jxml.save_storage(str(tmp_path / "j.xml"), nodes)
    assert (tmp_path / "t.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()
    for reader, path in ((txml, "j.xml"), (jxml, "t.xml")):
        got = reader.load_storage(str(tmp_path / path))
        for k, v in nodes.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(
                    got[k], v.reshape(-1, 1) if v.ndim == 1 else v)
            else:
                assert got[k] == v


@pytest.mark.parametrize("cam", [1, 2, 3, 4])
def test_save_camera_config_bytes_identical(tmp_path, cam):
    arrays = jxml.load_camera_config(RIG_XML, f"cam{cam}_config.xml")
    txml.save_camera_config(str(tmp_path / "t"), *arrays)
    jxml.save_camera_config(str(tmp_path / "j"), *arrays)
    t_bytes = (tmp_path / "t" / "config.xml").read_bytes()
    assert t_bytes == (tmp_path / "j" / "config.xml").read_bytes()
    for a, b in zip(txml.load_camera_config(str(tmp_path / "j")), arrays):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jxml.load_camera_config(str(tmp_path / "t")), arrays):
        np.testing.assert_array_equal(a, b)


def test_load_chessboard_info(tmp_path):
    path = str(tmp_path / "checkerboard.xml")
    txml.save_storage(path, {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
                             "CheckerBoardSquareSize": 115})
    assert txml.load_chessboard_info(path) == ((8, 6), 115.0)
    assert jxml.load_chessboard_info(path) == txml.load_chessboard_info(path)


# -- reconstruction -------------------------------------------------------


def test_load_rig(tmp_path):
    d = _rig_dir(tmp_path)
    got, want = trec.load_rig(d), jrec.load_rig(d)
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]


def _rigs(tmp_path):
    d = _rig_dir(tmp_path)
    return {"auto_extrinsics": (trec.load_rig(d), jrec.load_rig(d)),
            "synthetic": (tsyn.synthetic_cameras(4),
                          jsyn.synthetic_cameras(4))}


@pytest.mark.parametrize("rig", ["auto_extrinsics", "synthetic"])
def test_viewer_functions(tmp_path, rig):
    tcams, jcams = _rigs(tmp_path)[rig]
    assert trec.generate_grid(5, 7) == jrec.generate_grid(5, 7)
    (tp, tc), (jp, jc) = (trec.get_cam_positions(tcams, 115.0),
                          jrec.get_cam_positions(jcams, 115.0))
    assert tc == jc
    np.testing.assert_array_equal(np.array(tp), np.array(jp))
    for a, b in zip(trec.get_cam_rotation_matrices(tcams),
                    jrec.get_cam_rotation_matrices(jcams)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_colors", [True, False])
def test_write_ply_bytes_identical(tmp_path, with_colors):
    rng = np.random.default_rng(4)
    pos = rng.normal(0, 20, (50, 3)).astype(np.float32)
    col = rng.random((50, 3)).astype(np.float32) if with_colors else None
    trec.write_ply(str(tmp_path / "t.ply"), pos, col)
    jrec.write_ply(str(tmp_path / "j.ply"), pos, col)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


GRID32 = dict(nx=32, ny=32, nz=32)


def test_reconstructor_carves_as_the_reference():
    H, W = 60, 80
    rig_t = tconfig.RigConfig(image_height=H, image_width=W)
    rig_j = jconfig.RigConfig(image_height=H, image_width=W)
    tcams, masks, frames = tsyn.synthetic_rig(image_hw=(H, W))
    jcams = jsyn.synthetic_cameras(4, image_hw=(H, W))
    rt = trec.Reconstructor(tcams, tconfig.GridConfig(**GRID32), rig_t,
                            device="cpu")
    rj = jrec.Reconstructor(jcams, jconfig.GridConfig(**GRID32), rig_j)
    occ_t, col_t = rt.carve_frame(masks, frames)
    occ_j, col_j = rj.carve_frame(masks, frames)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    assert 0 < int(occ_t.sum()) < occ_t.numel()
    for a, b in zip(rt.carve_frame_compact(masks, frames),
                    rj.carve_frame_compact(masks, frames)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.occupancy_volume(masks, frames),
                                  rj.occupancy_volume(masks, frames))
    # the fused carve (no tables): equal to vbr_tpu's run op by op
    rt_f = trec.Reconstructor(tcams, tconfig.GridConfig(**GRID32), rig_t,
                              use_tables=False, device="cpu")
    rj_f = jrec.Reconstructor(jcams, jconfig.GridConfig(**GRID32), rig_j,
                              use_tables=False)
    with jax.disable_jit():
        occ_j, col_j = rj_f.carve_frame(masks, frames)
        compact_j = rj_f.carve_frame_compact(masks, frames)
        vol_j = rj_f.occupancy_volume(masks, frames)
    occ_f, col_f = rt_f.carve_frame(masks, frames)
    np.testing.assert_array_equal(occ_f.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(col_f.numpy(), np.asarray(col_j))
    for a, b in zip(rt_f.carve_frame_compact(masks, frames), compact_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt_f.occupancy_volume(masks, frames), vol_j)
    assert int((occ_f != occ_t).sum()) <= 1e-4 * occ_t.numel()


# -- projection-table cache -----------------------------------------------


def test_table_cache_key_matches_the_reference(tmp_path):
    """The key of the auto_extrinsics rig at the default 128³ grid and the
    rig's 486x644 images (no tables are built for it)."""
    tcams, jcams = _rigs(tmp_path)["auto_extrinsics"]
    key = tart._config_key(tcams, tconfig.GridConfig(), (486, 644))
    assert key == jart._config_key(jcams, jconfig.GridConfig(), (486, 644))
    assert len(key) == 16
    assert key != tart._config_key(tcams[:3], tconfig.GridConfig(), (486, 644))


def test_table_cache_loads_in_both_packages(tmp_path):
    H, W = 60, 80
    grid = dict(nx=16, ny=16, nz=16)
    tcams = tsyn.synthetic_cameras(4, image_hw=(H, W))
    jcams = jsyn.synthetic_cameras(4, image_hw=(H, W))
    # written by the JAX package, read by the port (its model builds none)
    jt = jart.cached_projection_tables(jcams, jconfig.GridConfig(**grid),
                                       (H, W), str(tmp_path / "j"))
    files = os.listdir(tmp_path / "j")
    m = tvh.VisualHull(tcams, tconfig.GridConfig(**grid),
                       tconfig.RigConfig(image_height=H, image_width=W),
                       cache_dir=str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(m.tables.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_array_equal(m.tables.lin_idx.numpy(),
                                  np.asarray(jt.lin_idx))
    assert os.listdir(tmp_path / "j") == files
    # written by the port, read by the JAX package
    tt = tart.cached_projection_tables(tcams, tconfig.GridConfig(**grid),
                                       (H, W), str(tmp_path / "t"),
                                       device="cpu")
    assert os.listdir(tmp_path / "t") == files
    key = tart._config_key(tcams, tconfig.GridConfig(**grid), (H, W))
    loaded = jart.load_projection_tables(
        str(tmp_path / "t" / f"proj_{key}.npz"), key)
    np.testing.assert_array_equal(np.asarray(loaded.valid), tt.valid.numpy())
    np.testing.assert_array_equal(np.asarray(loaded.lin_idx),
                                  tt.lin_idx.numpy())
    assert loaded.image_hw == tt.image_hw == (H, W)
    # a stale key loads nothing
    assert tart.load_projection_tables(
        str(tmp_path / "t" / f"proj_{key}.npz"), "0" * 16,
        device="cpu") is None


@pytest.mark.parametrize("fn", ["cached", "load"])
def test_table_cache_defaults_to_the_card(tmp_path, fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cams = tsyn.synthetic_cameras(4, image_hw=(60, 80))
    grid = tconfig.GridConfig(nx=16, ny=16, nz=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        if fn == "cached":
            tart.cached_projection_tables(cams, grid, (60, 80),
                                          str(tmp_path))
        else:
            tart.load_projection_tables(str(tmp_path / "none.npz"))
    assert os.listdir(tmp_path) == []


# -- assignment_api -------------------------------------------------------

H, W, C, K = 48, 64, 4, 50
FG_BGR = np.array([30, 220, 250], np.uint8)
MASK_PARAMS = [dataclasses.replace(p, figure_threshold=30.0,
                                   inner_threshold=6.0)
               for p in jconfig.DEFAULT_MASK_PARAMS]


def _seam_inputs(rng):
    """Background models (JAX states), a background image and 3 frames of
    the synthetic rig's sphere moving, with speckle."""
    cams = jsyn.synthetic_cameras(C, image_hw=(H, W), f=70.0)
    bg = rng.integers(40, 200, size=(C, H, W, 3), dtype=np.uint8)
    from vbr_tpu_torch.ops import color as tcolor

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
    frames = []
    for i in range(3):
        fr = bg.copy()
        for c, cp in enumerate(tsyn.synthetic_cameras(C, image_hw=(H, W),
                                                      f=70.0)):
            sil = tsyn.sphere_silhouette_mask(
                cp, np.array([60.0 + 50 * i, -40.0, -650.0]), 520.0,
                (H, W)) > 0
            fr[c][sil] = FG_BGR
            ys, xs = rng.integers(0, H, 8), rng.integers(0, W, 8)
            fr[c, ys, xs] = FG_BGR
        frames.append(fr)
    return cams, states, np.stack(frames)


class _Frames:
    def __init__(self, frames):
        self.it = iter(frames)

    def next_frames(self):
        return next(self.it, None)


@pytest.mark.parametrize("size", [(32, 16, 32), (20, 8, 16)],
                         ids=["blocked grid", "tables grid"])
def test_set_voxel_positions_matches_the_reference(tmp_path, monkeypatch,
                                                   size):
    """The port's seam, configured from a data directory and an npz
    background, against the reference's seam with its model and source
    set directly; on 8·sup-divisible grid the port carves with K1's plain
    version, on the other through the table step, and the reference
    through its table step on both."""
    rng = np.random.default_rng(11)
    jcams, states, frames = _seam_inputs(rng)
    data = tmp_path / "data"
    for i, cp in enumerate(jcams, start=1):
        txml.save_camera_config(str(data / f"cam{i}"), cp.K, cp.dist,
                                cp.rvec, cp.tvec)
    txml.save_storage(str(data / "checkerboard.xml"),
                      {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
                       "CheckerBoardSquareSize": 115})
    width, height, depth = size
    mj = jvh.VisualHull(jcams, jconfig.GridConfig(nx=width, ny=2 * height,
                                                  nz=depth),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=MASK_PARAMS)
    mj.bg_states = states
    mj.mog_params = [jconfig.MOGParams()] * C
    mj.save_background_models(str(tmp_path / "models"))
    monkeypatch.setattr(japi, "_model", mj)
    monkeypatch.setattr(japi, "_source", _Frames(frames))
    monkeypatch.setattr(japi, "_data_dir", str(data))

    tapi.configure(str(data), ArraySource(frames), str(tmp_path / "models"),
                   device="cpu",
                   rig=tconfig.RigConfig(image_height=H, image_width=W),
                   mask_params=[tconfig.MaskParams(**dataclasses.asdict(p))
                                for p in MASK_PARAMS])
    try:
        for f in range(len(frames)):
            got = tapi.set_voxel_positions(*size)
            want = japi.set_voxel_positions(*size)
            assert isinstance(got[0], list) and got == want
            assert len(got[0]) > 20, f"frame {f}: too few voxels"
        assert tapi._model.grid.shape == (width, 2 * height, depth)
        assert (tapi._model._ensure_btab() is None) == (size == (20, 8, 16))
        assert tapi.set_voxel_positions(*size) == ([], [])
        assert japi.set_voxel_positions(*size) == ([], [])
        assert tapi.generate_grid(3, 4) == japi.generate_grid(3, 4)
        (tp, tc), (jp, jc) = (tapi.get_cam_positions(),
                              japi.get_cam_positions())
        assert tc == jc
        np.testing.assert_array_equal(np.array(tp), np.array(jp))
        for a, b in zip(tapi.get_cam_rotation_matrices(),
                        japi.get_cam_rotation_matrices()):
            np.testing.assert_array_equal(a, b)
    finally:
        tapi.configure(None, None, None)


def test_set_voxel_positions_needs_configure():
    tapi.configure(None, None, None)
    with pytest.raises(RuntimeError, match="configure"):
        tapi.set_voxel_positions(8, 4, 8)


def test_from_data_dir(tmp_path):
    d = _rig_dir(tmp_path)
    m = tvh.VisualHull.from_data_dir(d, tconfig.GridConfig(**GRID32),
                                     train_background=False, device="cpu")
    assert [dataclasses.astuple(c) for c in m.cameras] == \
        [dataclasses.astuple(c) for c in jrec.load_rig(d)]
    # training decodes cam*/background.avi, which this rig lacks
    with pytest.raises(FileNotFoundError, match="background.avi"):
        tvh.VisualHull.from_data_dir(d, tconfig.GridConfig(**GRID32),
                                     device="cpu")


def test_array_source_ends_with_none():
    frames = np.zeros((2, C, 4, 6, 3), np.uint8)
    src = ArraySource(frames)
    assert src.next_frames().shape == (C, 4, 6, 3)
    assert src.next_frames() is not None
    assert src.next_frames() is None
    assert ArraySource(iter([frames[0]])).next_frames().dtype == np.uint8
