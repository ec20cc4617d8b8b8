"""Port parity: camera math, carve tables and the blocked carve (K1).

The same seeded numpy inputs go through ``vbr_tpu`` (JAX on the CPU, the
Pallas carve in interpret mode) and ``vbr_tpu_torch`` on the CPU (the
kernel's plain version); every stage is integer or exact f64, so
everything is compared with zero tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vbr_tpu.ops import camera as jcam
from vbr_tpu.ops import carve as jcarve
from vbr_tpu.ops import carve_pallas as jcp
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.ops import camera as tcam
from vbr_tpu_torch.ops import carve as tcarve
from vbr_tpu_torch.ops import carve_blocked as tcb
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


H, W = 64, 96
C = 4
GRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)


def _t(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def rig():
    cams_j = jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    cams_t = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    rng = np.random.default_rng(11)
    center = np.array([60.0, -40.0, -650.0])
    masks = np.stack([tsyn.sphere_silhouette_mask(cp, center, 520.0, (H, W))
                      for cp in cams_t])
    speckle = rng.random((C, H, W)) < 0.03
    masks = np.where(speckle, 255 - masks, masks).astype(np.uint8)
    frames = rng.integers(0, 256, size=(C, H, W, 3), dtype=np.uint8)
    return cams_j, cams_t, masks, frames


def test_config_copies_match():
    for jcls, tcls in ((jconfig.GridConfig, tconfig.GridConfig),
                       (jconfig.MaskParams, tconfig.MaskParams),
                       (jconfig.MOGParams, tconfig.MOGParams),
                       (jconfig.RigConfig, tconfig.RigConfig)):
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    assert ([dataclasses.astuple(p) for p in jconfig.DEFAULT_MASK_PARAMS]
            == [dataclasses.astuple(p) for p in tconfig.DEFAULT_MASK_PARAMS])
    np.testing.assert_array_equal(jconfig.GridConfig(**GRID).voxel_points(),
                                  tconfig.GridConfig(**GRID).voxel_points())


def test_synthetic_rig_matches():
    cams_j, masks_j, frames_j = jsyn.synthetic_rig(image_hw=(H, W))
    cams_t, masks_t, frames_t = tsyn.synthetic_rig(image_hw=(H, W))
    assert ([dataclasses.astuple(c) for c in cams_j]
            == [dataclasses.astuple(c) for c in cams_t])
    np.testing.assert_array_equal(masks_j, masks_t)
    np.testing.assert_array_equal(frames_j, frames_t)


def test_camera_math_matches():
    rng = np.random.default_rng(2)
    pts = rng.normal(0.0, 800.0, size=(500, 3))
    for _ in range(4):
        rvec = rng.normal(0.0, 1.0, 3)
        tvec = rng.normal(0.0, 200.0, 3) + np.array([0.0, 0.0, 4000.0])
        K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
        dist = rng.normal(0.0, 0.05, 5)
        np.testing.assert_array_equal(
            tcam.project_points(pts, rvec, tvec, K, dist),
            jcam.project_points(pts, rvec, tvec, K, dist, xp=np))
        R = tcam.rodrigues(rvec)
        np.testing.assert_array_equal(R, jcam.rodrigues(rvec, xp=np))
        np.testing.assert_array_equal(tcam.rodrigues_inverse(R),
                                      jcam.rodrigues_inverse(R, xp=np))


def test_projection_tables_match(rig):
    cams_j, cams_t, _, _ = rig
    ref = jcarve._build_tables_f64(cams_j, jconfig.GridConfig(**GRID), (H, W))
    got = tcarve.build_projection_tables(cams_t, tconfig.GridConfig(**GRID),
                                         (H, W), device="cpu")
    np.testing.assert_array_equal(_t(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(_t(got.lin_idx), np.asarray(ref.lin_idx))


@pytest.mark.parametrize("sup", [(2, 2, 4), (1, 1, 1)])
def test_block_tables_match(rig, sup):
    cams_j, cams_t, _, _ = rig
    ref = jcp.build_block_tables(cams_j, jconfig.GridConfig(**GRID), (H, W),
                                 sup=sup, accelerate=False)
    got = tcb.build_block_tables(cams_t, tconfig.GridConfig(**GRID), (H, W),
                                 sup=sup, device="cpu")
    assert tcb.tables_static_tuple(got) == jcp.tables_static_tuple(ref)
    assert got.n_fcells_hw == ref.n_fcells_hw
    for name in ("pk", "lcc", "vorig", "uorig", "allv"):
        np.testing.assert_array_equal(_t(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))
    for name in ("ry", "rx"):
        np.testing.assert_array_equal(
            _t(getattr(got, name)),
            np.asarray(getattr(ref, name)).astype(np.float32))
    np.testing.assert_array_equal(got.perm, ref.perm)


def test_odd_grid_rejected(rig):
    _, cams_t, _, _ = rig
    with pytest.raises(ValueError, match="divisible"):
        tcb.build_block_tables(cams_t, tconfig.GridConfig(nx=20, ny=16,
                                                          nz=16), (H, W),
                               device="cpu")


@pytest.fixture(scope="module")
def tables(rig):
    cams_j, cams_t, _, _ = rig
    return (jcp.build_block_tables(cams_j, jconfig.GridConfig(**GRID), (H, W),
                                   accelerate=False),
            tcb.build_block_tables(cams_t, tconfig.GridConfig(**GRID), (H, W),
                                   device="cpu"))


@pytest.mark.parametrize("thr", [4, 3])
def test_block_activity_matches(rig, tables, thr):
    _, _, masks, _ = rig
    jt, tt = tables
    ja, jf = jcp._block_activity(jnp.asarray(masks), thr, jt.allv, jt.ry,
                                 jt.rx)
    ta, tf = tcb.block_activity(torch.from_numpy(masks), thr, tt.allv,
                                tt.ry, tt.rx)
    np.testing.assert_array_equal(_t(ta), np.asarray(ja))
    np.testing.assert_array_equal(_t(tf), np.asarray(jf))
    assert _t(ta).any()


@pytest.mark.parametrize("layout", ["canonical", "blocked"])
def test_carve_blocked_matches_pallas(rig, tables, layout):
    _, _, masks, frames = rig
    jt, tt = tables
    occ_j, col_j = jcp.carve_blocked(
        jnp.asarray(masks), jnp.asarray(frames[1]), jt, views_threshold=4,
        interpret=True, layout=layout)
    occ_t, col_t = tcb.carve_blocked(
        torch.from_numpy(masks), torch.from_numpy(frames[1]), tt,
        views_threshold=4, layout=layout)
    np.testing.assert_array_equal(_t(occ_t), np.asarray(occ_j))
    np.testing.assert_array_equal(_t(col_t), np.asarray(col_j))
    assert _t(occ_t).sum() > 0


def test_carve_from_tables_and_compaction_match(rig, tables):
    cams_j, cams_t, masks, frames = rig
    jtab = jcarve._build_tables_f64(cams_j, jconfig.GridConfig(**GRID), (H, W))
    ttab = tcarve.build_projection_tables(cams_t, tconfig.GridConfig(**GRID),
                                          (H, W), device="cpu")
    occ_j, col_j = jcarve.carve_from_tables(
        jnp.asarray(masks), jnp.asarray(frames), jtab.valid, jtab.lin_idx,
        views_threshold=3, color_camera=1)
    occ_t, col_t = tcarve.carve_from_tables(
        torch.from_numpy(masks), torch.from_numpy(frames), ttab.valid,
        ttab.lin_idx, views_threshold=3, color_camera=1)
    np.testing.assert_array_equal(_t(occ_t), np.asarray(occ_j))
    np.testing.assert_array_equal(_t(col_t), np.asarray(col_j))
    grid_j, grid_t = jconfig.GridConfig(**GRID), tconfig.GridConfig(**GRID)
    for a, b in zip(tcarve.compact_voxels(occ_t, col_t, grid_t),
                    jcarve.compact_voxels(np.asarray(occ_j),
                                          np.asarray(col_j), grid_j)):
        np.testing.assert_array_equal(a, b)

    jt, tt = tables
    occ_bj, col_bj = jcp.carve_blocked(
        jnp.asarray(masks), jnp.asarray(frames[1]), jt, views_threshold=4,
        interpret=True, layout="blocked")
    occ_bt, col_bt = tcb.carve_blocked(
        torch.from_numpy(masks), torch.from_numpy(frames[1]), tt,
        views_threshold=4, layout="blocked")
    for a, b in zip(tcb.compact_voxels_blocked(occ_bt, col_bt, tt, grid_t),
                    jcp.compact_voxels_blocked(occ_bj, col_bj, jt, grid_j)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcb.canonicalize_host(occ_bt, tt),
                                  jcp.canonicalize_host(occ_bj, jt))


def test_kernel_wrapper_uses_plain_on_cpu_only(rig, tables):
    """The K1 wrapper runs the plain version for CPU tensors, launches
    nothing, and refuses other devices."""
    _, _, masks, frames = rig
    _, tt = tables
    act, full = tcb.block_activity(torch.from_numpy(masks), 4, tt.allv,
                                   tt.ry, tt.rx)
    before = tcb.K1.launches
    args = (tt.pk, tt.lcc, act, full, torch.from_numpy(masks),
            torch.from_numpy(frames[1]))
    got = tcb.carve_blocked_kernel(*args, color_camera=1, views_threshold=4)
    want = tcb.carve_blocked_plain(*args, color_camera=1, views_threshold=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_t(a), _t(b))
    assert tcb.K1.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        tcb.carve_blocked_kernel(*(a.to("meta") for a in args),
                                 color_camera=1, views_threshold=4)


# -- the carve kernel's design, as far as the CPU can hold it ------------------


@pytest.mark.parametrize("plane", ["occ", "col"])
def test_four_voxels_per_word_is_the_byte_layout(plane):
    """K1 stores four voxels per 32-bit word, byte e = voxel 4v + e: on a
    little-endian machine that is the u8 layout ``compact_voxels_blocked``
    and the plain version use."""
    rng = np.random.default_rng(31)
    shape = (3, 5, tcb.BV) if plane == "occ" else (3, 5, 3, tcb.BV)
    hi = 2 if plane == "occ" else 256
    vox = rng.integers(0, hi, shape, dtype=np.uint8)
    quad = vox.reshape(shape[:-1] + (tcb.BV // 4, 4)).astype(np.uint32)
    words = (quad[..., 0] | quad[..., 1] << 8 | quad[..., 2] << 16
             | quad[..., 3] << 24)  # what thread v of the kernel stores
    assert words.shape[-1] == 128
    np.testing.assert_array_equal(words.view(np.uint8).reshape(shape), vox)
    as_words = torch.from_numpy(vox).view(torch.int32)
    np.testing.assert_array_equal(as_words.numpy().view(np.uint32), words)
    assert torch.equal(as_words.view(torch.uint8), torch.from_numpy(vox))


@pytest.mark.parametrize("resident", [1, 64, 1320, 1584, 5000])
@pytest.mark.parametrize("nblk", [1, 64, 4095, 4096])
def test_persistent_partition_visits_every_block_once(nblk, resident):
    """CTA i of G = min(nblk, resident CTAs) takes sub-blocks i, i + G, ...
    in rounds of 128 (one flag pair per thread and round)."""
    G = min(nblk, resident)
    seen = np.zeros(nblk, np.int64)
    for cta in range(G):
        n_own = (nblk - cta + G - 1) // G
        assert n_own >= 1
        for base in range(0, n_own, 128):
            for j in range(min(128, n_own - base)):
                seen[cta + (base + j) * G] += 1
    assert (seen == 1).all()


def _design_case(case, rig):
    cams_j, cams_t, masks, frames = rig
    kw = dict(color_camera=1)
    thr = 4
    if case == "empty":
        masks = np.zeros_like(masks)
    elif case == "full":
        masks = np.full_like(masks, 255)
    elif case == "threshold_3":
        thr = 3
    elif case == "three_cameras":
        cams_j, cams_t, masks, thr = cams_j[:3], cams_t[:3], masks[:3], 3
    elif case == "color_camera_2":
        kw = dict(color_camera=2)
    return cams_j, cams_t, np.ascontiguousarray(masks), frames, kw, thr


@pytest.mark.parametrize("case", ["empty", "full", "threshold_3",
                                  "three_cameras", "color_camera_2"])
def test_plain_matches_pallas_on_the_card_check_inputs(rig, case):
    """The inputs that hold K1 on the card beyond the production frame:
    the plain version equals the Pallas kernel in interpret mode on each."""
    cams_j, cams_t, masks, frames, kw, thr = _design_case(case, rig)
    jt = jcp.build_block_tables(cams_j, jconfig.GridConfig(**GRID), (H, W),
                                accelerate=False, **kw)
    tt = tcb.build_block_tables(cams_t, tconfig.GridConfig(**GRID), (H, W),
                                **kw, device="cpu")
    image = frames[kw["color_camera"]]
    occ_j, col_j = jcp.carve_blocked(
        jnp.asarray(masks), jnp.asarray(image), jt, views_threshold=thr,
        interpret=True, layout="blocked")
    occ_t, col_t = tcb.carve_blocked(
        torch.from_numpy(masks), torch.from_numpy(image), tt,
        views_threshold=thr, layout="blocked")
    np.testing.assert_array_equal(_t(occ_t), np.asarray(occ_j))
    np.testing.assert_array_equal(_t(col_t), np.asarray(col_j))
    n_occ = int(_t(occ_t).sum())
    assert (n_occ == 0) if case == "empty" else n_occ > 0
    if case == "full":  # every voxel that all cameras see
        assert n_occ == int((_t(tt.pk) >> 10 != tcb.INVALID_ROW)
                            .all(axis=2).sum())
