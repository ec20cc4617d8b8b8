"""Port parity: extrinsic calibration (``pipelines/auto_extrinsics.py``)
and its geometric evaluation (``pipelines/extrinsics_eval.py``).

The same seeded inputs go through ``vbr_tpu`` and the port on the CPU.
What is compared how:

* Host copies (``flip_pose_180``, ``convex_fill``, ``detect_black_squares``,
  ``pattern_quad``, ``orient_and_fit_homography``, ``photometric_mse``, the
  readers ``temporal_mean_gray`` and ``median_background``, the
  labeller): EXACT; ``photometric_mse`` is also held to rtol 1e-9.
* ``largest_change_region`` (its dilation on the device): EXACT.
* ``photometric_refine`` (f64 autograd in the port, a jitted f64 JAX
  program in ``vbr_tpu``): within ``REFINE_RAD`` rad and ``REFINE_MM`` mm,
  or 10× ``vbr_tpu``'s own spread under a one-ulp change of the start
  where that is larger (measured: the spread ~4e-16 rad / ~1e-12 mm, the
  port ~3e-16 rad / ~6e-13 mm from ``vbr_tpu``), and the loss to rtol 1e-9.
* The vote, ``hull_coverage`` and ``carve_silhouette_ab``: votes, flips,
  occupancy and coverages EXACT against the same ``vbr_tpu`` arithmetic on
  ``vbr_tpu``'s f64 tables (``build_projection_tables(accelerate=False)``);
  the port's tables equal the f64 projection.
* ``measure_saddle_corners`` / ``evaluate_pose_sets``: the port's
  ``corner_subpix`` agrees with ``vbr_tpu``'s to ``SUBPIX_PX``, so the
  measured corners agree to that and a ``kept`` flag may differ only for a
  corner whose distances lie within ``SUBPIX_PX`` of a threshold.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vbr_tpu.ops import carve as jcarve
from vbr_tpu.ops import corners as jcorners
from vbr_tpu.pipelines import auto_extrinsics as jax_ax
from vbr_tpu.pipelines import calibration as jcalib
from vbr_tpu.pipelines import extrinsics_eval as jev
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu.utils import video as jvio
from vbr_tpu_torch.ops import corners as tcorners
from vbr_tpu_torch.pipelines import auto_extrinsics as ax
from vbr_tpu_torch.pipelines import extrinsics_eval as ev
from vbr_tpu_torch.utils import config as tconfig

from tests.test_auto_extrinsics import TestSyntheticBoard, _object_points
from tests.test_extrinsics_eval import _synthetic_rig as _eval_rig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SQ = 115.0
PATTERN = (8, 6)
CPU = "cpu"
REFINE_RAD = 1e-6  # see the module docstring
REFINE_MM = 1e-3
SUBPIX_PX = 1e-3  # corner_subpix, the port against vbr_tpu on the CPU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _jcam(cp):
    """The port's CameraParams as ``vbr_tpu``'s."""
    return jconfig.CameraParams(**dataclasses.asdict(cp))


def _tcam(cp):
    return tconfig.CameraParams(**dataclasses.asdict(cp))


# -- flip_pose_180 ----------------------------------------------------------

POSES = [(np.array([0.3, -1.2, 0.5]), np.array([100.0, -300.0, 3600.0])),
         (np.array([0.4, -1.0, 0.3]), np.array([50.0, -200.0, 3500.0])),
         (np.array([2.9, 0.1, -0.4]), np.array([-700.0, 20.0, 2900.0]))]


@pytest.mark.parametrize("i", range(len(POSES)))
def test_flip_pose_180_matches_and_double_flip_is_identity(i):
    rv, tv = POSES[i]
    got = ax.flip_pose_180(rv, tv, SQ, PATTERN)
    want = jax_ax.flip_pose_180(rv, tv, SQ, PATTERN)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    rv2, tv2 = ax.flip_pose_180(*got, SQ, PATTERN)
    np.testing.assert_allclose(rv2, rv, atol=1e-10)
    np.testing.assert_allclose(tv2, tv, atol=1e-8)


def test_flip_reverses_corner_order():
    """The grid projected under the flipped pose is the original
    projection in reverse order (the board's 180° symmetry)."""
    from vbr_tpu_torch.ops import camera as tcam

    rv, tv = POSES[1]
    K = np.array([[490.0, 0, 322], [0, 490.0, 243], [0, 0, 1.0]])
    obj = _object_points()
    a = tcam.project_points(obj, rv, tv, K, np.zeros(5))
    b = tcam.project_points(obj, *ax.flip_pose_180(rv, tv, SQ, PATTERN), K,
                            np.zeros(5))
    np.testing.assert_allclose(b, a[::-1], atol=1e-8)


# -- the synthetic board of tests/test_auto_extrinsics.py ---------------------

K_BOARD = np.array([[490.0, 0, 322], [0, 492.0, 243], [0, 0, 1.0]])
DIST_BOARD = np.array([-0.3, 0.1, 0.001, -0.001, 0.0])
RV_BOARD = np.array([1.1, -0.2, 0.15])
TV_BOARD = np.array([-380.0, -180.0, 2400.0])


@pytest.fixture(scope="module")
def board():
    """The JAX test's rendered board, its sheet, and both packages'
    stages up to the PnP start."""
    gray, _ = TestSyntheticBoard()._render(RV_BOARD, TV_BOARD, K_BOARD,
                                           DIST_BOARD)
    region = np.abs(gray - 120.0) > 25
    pts = np.stack(np.nonzero(region)[::-1], -1).astype(np.float64)
    hull = jcorners._convex_hull(pts)
    sheet = jax_ax.convex_fill(hull, gray.shape)
    cents, thr = jax_ax.detect_black_squares(gray, sheet)
    quad = jax_ax.pattern_quad(gray, sheet)
    H, ipts, nm = jax_ax.orient_and_fit_homography(gray, quad, cents,
                                                   K_BOARD, DIST_BOARD,
                                                   PATTERN)
    rv0, tv0 = jcalib.solve_pnp(_object_points(), ipts, K_BOARD, DIST_BOARD)
    return dict(gray=gray, pts=pts, hull=hull, sheet=sheet, cents=cents,
                thr=thr, quad=quad, H=H, ipts=ipts, nm=nm,
                rv0=np.asarray(rv0).ravel(), tv0=np.asarray(tv0).ravel())


def test_convex_fill_matches(board):
    assert np.array_equal(tcorners._convex_hull(board["pts"]), board["hull"])
    got = ax.convex_fill(board["hull"], board["gray"].shape)
    np.testing.assert_array_equal(got, board["sheet"])


@pytest.mark.parametrize("seed", range(3))
def test_convex_fill_matches_on_random_polygons(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 70, (12, 2))
    hull = jcorners._convex_hull(pts)
    np.testing.assert_array_equal(ax.convex_fill(hull, (48, 64)),
                                  jax_ax.convex_fill(hull, (48, 64)))


def test_detect_black_squares_matches(board):
    cents, thr = ax.detect_black_squares(board["gray"], board["sheet"])
    assert len(cents) >= 20 and thr == board["thr"]
    np.testing.assert_array_equal(cents, board["cents"])


def test_pattern_quad_matches(board):
    np.testing.assert_array_equal(
        ax.pattern_quad(board["gray"], board["sheet"]), board["quad"])


def test_orient_and_fit_homography_matches(board):
    H, ipts, nm = ax.orient_and_fit_homography(
        board["gray"], board["quad"], board["cents"], K_BOARD, DIST_BOARD,
        PATTERN)
    assert nm == board["nm"] >= 20
    np.testing.assert_array_equal(H, np.asarray(board["H"]))
    np.testing.assert_array_equal(ipts, np.asarray(board["ipts"]))


def test_photometric_refine_matches_reference(board):
    """250 Adam steps from the PnP start: the port within the stated
    tolerance of ``vbr_tpu``, which is 10× ``vbr_tpu``'s own spread under
    a one-ulp change of the start where that exceeds REFINE_RAD /
    REFINE_MM; the pose within the JAX test's bounds of the truth."""
    g, rv0, tv0 = board["gray"], board["rv0"], board["tv0"]
    args = (K_BOARD, DIST_BOARD)
    want = jax_ax.photometric_refine(g, *args, rv0, tv0, SQ, PATTERN,
                                     iters=250)
    nudged = jax_ax.photometric_refine(g, *args, np.nextafter(rv0, np.inf),
                                       tv0, SQ, PATTERN, iters=250)
    tol_rad = max(REFINE_RAD, 10 * np.abs(want[0] - nudged[0]).max())
    tol_mm = max(REFINE_MM, 10 * np.abs(want[1] - nudged[1]).max())
    rv, tv, L = ax.photometric_refine(g, *args, rv0, tv0, SQ, PATTERN,
                                      iters=250, device=CPU)
    assert np.abs(rv - want[0]).max() <= tol_rad
    assert np.abs(tv - want[1]).max() <= tol_mm
    np.testing.assert_allclose(L, want[2], rtol=1e-9)
    cand = [(rv, tv), ax.flip_pose_180(rv, tv, SQ, PATTERN)]
    r_best, t_best = min(cand, key=lambda c: np.linalg.norm(c[0] - RV_BOARD))
    assert np.linalg.norm(r_best - RV_BOARD) < 0.01
    assert np.linalg.norm(t_best - TV_BOARD) < 25.0


def test_photometric_refine_without_steps_evaluates_the_start(board):
    g, rv0, tv0 = board["gray"], board["rv0"], board["tv0"]
    want = jax_ax.photometric_refine(g, K_BOARD, DIST_BOARD, rv0, tv0, SQ,
                                     PATTERN, iters=0)
    rv, tv, L = ax.photometric_refine(g, K_BOARD, DIST_BOARD, rv0, tv0, SQ,
                                      PATTERN, iters=0, device=CPU)
    np.testing.assert_array_equal(rv, rv0)
    np.testing.assert_array_equal(tv, tv0)
    np.testing.assert_allclose(L, want[2], rtol=1e-9)


def test_photometric_refine_graph_route_needs_a_card(board):
    with pytest.raises(ValueError, match="CUDA"):
        ax.photometric_refine(board["gray"], K_BOARD, DIST_BOARD,
                              board["rv0"], board["tv0"], SQ, iters=1,
                              device=CPU, route="graph")


def test_photometric_mse_matches_and_ranks_the_true_pose():
    gray, _ = TestSyntheticBoard()._render(RV_BOARD, TV_BOARD, K_BOARD,
                                           np.zeros(5))
    vals = []
    for tv in (TV_BOARD, TV_BOARD + [30, 0, 0], TV_BOARD + [0, 0, 50]):
        got = ax.photometric_mse(gray, K_BOARD, np.zeros(5), RV_BOARD, tv,
                                 SQ, PATTERN)
        want = jax_ax.photometric_mse(gray, K_BOARD, np.zeros(5), RV_BOARD,
                                      tv, SQ, PATTERN)
        np.testing.assert_allclose(got, want, rtol=1e-9)
        vals.append(got)
    assert vals[0] < min(vals[1:])


# -- readers and the change region ----------------------------------------


def _sequence(seed, T, H=30, W=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (T, H, W, 3)).astype(np.uint8)


@pytest.fixture
def reference_reader(monkeypatch):
    """``vbr_tpu``'s video readers over in-memory sequences, keyed by
    path."""
    store = {}
    monkeypatch.setattr(jvio, "frame_iterator", lambda p: iter(store[p]))
    monkeypatch.setattr(jvio, "get_frame", lambda p, i: store[p][i])
    return store


@pytest.mark.parametrize("T, max_frames", [(5, 64), (40, 32), (70, 64)])
def test_temporal_mean_gray_matches(reference_reader, T, max_frames):
    seq = _sequence(T, T)
    reference_reader["v"] = seq
    want = jax_ax.temporal_mean_gray("v", max_frames=max_frames)
    np.testing.assert_array_equal(ax.temporal_mean_gray(seq, max_frames),
                                  want)
    np.testing.assert_array_equal(  # a one-pass iterable gives the same
        ax.temporal_mean_gray(iter(list(seq)), max_frames), want)


@pytest.mark.parametrize("T", [111, 130, 45])
def test_median_background_matches(reference_reader, T):
    """12 samples (an even count: the mean of the two middle values, not
    the lower one) where the sequence has them."""
    seq = _sequence(T + 1, T)
    reference_reader["b"] = seq
    want = jax_ax.median_background("b")
    got = ax.median_background(iter(seq))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert T < 111 or (got % 1 == 0.5).any()


def test_temporal_mean_gray_without_frames_raises():
    with pytest.raises(ValueError):
        ax.temporal_mean_gray(iter([]))


@pytest.mark.parametrize("seed", range(4))
def test_label_host_matches(seed):
    rng = np.random.default_rng(seed)
    m = rng.random(tuple(rng.integers(1, 60, 2))) < rng.uniform(0.2, 0.8)
    got, n = ax._label_host(m)
    want, k = jax_ax._label_host(m)
    assert n == k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", [40.0, 35.0])
def test_largest_change_region_matches(board, threshold):
    """A frame with the board and a smaller changed blob against its
    background: the same winner, dilated alike."""
    rng = np.random.default_rng(int(threshold))
    bg = np.full(board["gray"].shape + (3,), 120.0) + rng.normal(
        0, 2, board["gray"].shape + (3,))
    frame = np.clip(board["gray"][..., None].repeat(3, -1), 0, 255)
    frame[20:60, 30:90] = 10
    frame = frame.astype(np.uint8)
    want = jax_ax.largest_change_region(bg, frame, threshold)
    got = ax.largest_change_region(bg, frame, threshold, device=CPU)
    assert want is not None and want.sum() > 1000
    np.testing.assert_array_equal(got, want)
    flat = np.full_like(frame, 120)
    assert ax.largest_change_region(bg, flat, threshold, device=CPU) is None


# -- the vote and the carve metrics -------------------------------------------


def _reference_coverage_f64(masks, jcset, grid):
    """``vbr_tpu``'s ``hull_coverage`` arithmetic on its f64 tables."""
    C, H, W = masks.shape
    tabs = jcarve.build_projection_tables(jcset, grid, (H, W),
                                          accelerate=False)
    occ, _ = jcarve.carve_from_tables(
        jnp.asarray(masks), jnp.zeros((C, H, W, 3), jnp.uint8), tabs.valid,
        tabs.lin_idx, views_threshold=C)
    occ = np.asarray(occ)
    lin, val = np.asarray(tabs.lin_idx), np.asarray(tabs.valid)
    covs = []
    for ci in range(C):
        pix = np.zeros(H * W, bool)
        pix[lin[ci][occ & val[ci]]] = True
        sil = masks[ci].reshape(-1) > 0
        covs.append(float((pix & sil).sum() / max(sil.sum(), 1)))
    return occ, covs


def _reference_votes_f64(jcams, cand, masks, grid):
    """``vbr_tpu``'s vote on its f64 tables."""
    C = len(jcams)
    votes = {}
    for code in range(2 ** (C - 1)):
        flips = (False,) + tuple(bool((code >> i) & 1) for i in range(C - 1))
        rig = []
        for c in range(C):
            rv, tv = cand[c]
            if flips[c]:
                rv, tv = jax_ax.flip_pose_180(rv, tv, SQ, PATTERN)
            rig.append(dataclasses.replace(
                jcams[c], rvec_xyz=tuple(np.asarray(rv).ravel()),
                tvec_xyz=tuple(np.asarray(tv).ravel())))
        votes[flips] = int(_reference_coverage_f64(masks, rig, grid)[0].sum())
    return votes


@pytest.fixture(scope="module")
def flipped_rig():
    """``synthetic_rig`` with camera 2's candidate pose flipped."""
    jcams, masks, _ = jsyn.synthetic_rig()
    cand = []
    for i, cp in enumerate(jcams):
        rv, tv = np.asarray(cp.rvec), np.asarray(cp.tvec)
        if i == 2:
            rv, tv = jax_ax.flip_pose_180(rv, tv, SQ, PATTERN)
        cand.append((np.asarray(rv), np.asarray(tv)))
    return jcams, masks, cand


def test_resolve_rig_orientation_matches(flipped_rig):
    jcams, masks, cand = flipped_rig
    flips, votes = ax.resolve_rig_orientation(
        [_tcam(c) for c in jcams], cand, masks, SQ, PATTERN, device=CPU)
    want_flips, want_votes = jax_ax.resolve_rig_orientation(
        jcams, cand, masks, SQ, PATTERN)
    assert flips == want_flips == [False, False, True, False]
    assert votes == want_votes
    assert votes == _reference_votes_f64(
        jcams, cand, masks, jconfig.GridConfig(nx=32, ny=32, nz=32))


@pytest.mark.parametrize("edge", [32, 64])
def test_hull_coverage_matches_f64_reference(edge):
    jcams, masks, _ = jsyn.synthetic_rig()
    grid = tconfig.GridConfig(nx=edge, ny=edge, nz=edge)
    jgrid = jconfig.GridConfig(nx=edge, ny=edge, nz=edge)
    occ, covs = ev.hull_coverage(masks, [_tcam(c) for c in jcams], grid,
                                 device=CPU)
    want_occ, want_covs = _reference_coverage_f64(masks, jcams, jgrid)
    assert occ.sum() > 100 and min(covs) > 0.1
    np.testing.assert_array_equal(occ, want_occ)
    assert covs == want_covs
    ref_occ, ref_covs = jev.hull_coverage(masks, jcams, jgrid)
    np.testing.assert_array_equal(np.asarray(ref_occ), want_occ)
    assert ref_covs == want_covs


@pytest.fixture(scope="module")
def committed_rig():
    """The committed rig (``artifacts/auto_extrinsics``) and its
    silhouettes (``artifacts/final``) at 486×644."""
    cs = _chip_smoke()
    cams = [tconfig.CameraParams.from_arrays(*c)
            for c in cs.rig_cameras(cs.RIG_HW)]
    masks = cs.rig_silhouettes(cs.RIG_HW).astype(np.uint8) * 255
    return cams, masks


@pytest.mark.parametrize("flip_cam", [0, 2])
def test_carve_silhouette_ab_matches_on_the_committed_rig(committed_rig,
                                                          flip_cam):
    """The committed poses against one camera flipped, at 32³: the port's
    report equals ``vbr_tpu``'s arithmetic on its f64 tables, and the
    flipped set loses coverage and voxels."""
    cams, masks = committed_rig
    grid = tconfig.GridConfig(nx=32, ny=32, nz=32)
    jgrid = jconfig.GridConfig(nx=32, ny=32, nz=32)
    poses_a = [(c.rvec, c.tvec) for c in cams]
    poses_b = list(poses_a)
    poses_b[flip_cam] = ax.flip_pose_180(*poses_b[flip_cam])
    rep = ev.carve_silhouette_ab(masks, cams, poses_a, poses_b, grid,
                                 device=CPU)

    def jset(poses):
        return [dataclasses.replace(_jcam(c), rvec_xyz=tuple(p[0]),
                                    tvec_xyz=tuple(p[1]))
                for c, p in zip(cams, poses)]

    occ_a, cov_a = _reference_coverage_f64(masks, jset(poses_a), jgrid)
    occ_b, cov_b = _reference_coverage_f64(masks, jset(poses_b), jgrid)
    assert rep.coverage_a == cov_a and rep.coverage_b == cov_b
    assert rep.voxels_a == int(occ_a.sum()) and rep.voxels_b == int(
        occ_b.sum())
    assert rep.hull_iou_ab == float((occ_a & occ_b).sum()
                                    / max((occ_a | occ_b).sum(), 1))
    assert np.mean(rep.coverage_b) < np.mean(rep.coverage_a)
    assert rep.voxels_b < rep.voxels_a
    ref = jev.carve_silhouette_ab(masks, [_jcam(c) for c in cams], poses_a,
                                  poses_b, jgrid)
    assert dataclasses.asdict(ref) == dataclasses.asdict(rep)


# -- saddle corners and the geometric report ----------------------------------


@pytest.fixture(scope="module")
def eval_rig():
    """The JAX test's two-camera rendered rig, true and perturbed poses."""
    cams, poses_true, grays = _eval_rig(2)
    rng = np.random.default_rng(11)
    pert = [(rv + rng.normal(0, 0.0015, 3), tv + rng.normal(0, 10.0, 3))
            for rv, tv in poses_true]
    return cams, poses_true, pert, grays


def _near_threshold(ra, rb, sa, sb, shape, win=3, seed_tol=0.35):
    """Corners whose keep test lies within SUBPIX_PX of a threshold."""
    H, W = shape
    d = np.linalg.norm(ra - rb, axis=1)
    near = np.abs(d - seed_tol) < SUBPIX_PX
    for r, s in ((ra, sa), (rb, sb)):
        near |= np.abs(np.linalg.norm(r - s, axis=1) - 2.5 * win) < SUBPIX_PX
    for v, hi in ((ra[:, 0], W - win - 1), (ra[:, 1], H - win - 1)):
        near |= (np.abs(v - win) < SUBPIX_PX) | (np.abs(v - hi) < SUBPIX_PX)
    return near


def test_measure_saddle_corners_matches(eval_rig):
    cams, poses_true, pert, grays = eval_rig
    for ci, cp in enumerate(cams):
        sa = jev.predicted_corners(cp, *poses_true[ci])
        sb = jev.predicted_corners(cp, *pert[ci])
        np.testing.assert_array_equal(
            ev.predicted_corners(_tcam(cp), *poses_true[ci]), sa)
        m, k = ev.measure_saddle_corners(grays[ci], sa, sb, device=CPU)
        jm, jk = jev.measure_saddle_corners(grays[ci], sa, sb)
        jm, jk = np.asarray(jm), np.asarray(jk)
        g = torch.from_numpy(np.asarray(grays[ci], np.float32))
        ra = tcorners.corner_subpix(g, sa, (3, 3), device=CPU).numpy()
        rb = tcorners.corner_subpix(g, sb, (3, 3), device=CPU).numpy()
        near = _near_threshold(ra, rb, sa, sb, grays[ci].shape)
        assert k.sum() >= 40
        assert np.array_equal(k[~near], jk[~near]), np.nonzero(k != jk)
        both = k & jk
        assert np.abs(m[both] - jm[both]).max() <= SUBPIX_PX


def test_evaluate_pose_sets_matches(eval_rig):
    cams, poses_true, pert, grays = eval_rig
    got = ev.evaluate_pose_sets(grays, [_tcam(c) for c in cams], poses_true,
                                pert, device=CPU)
    want = jev.evaluate_pose_sets(grays, cams, poses_true, pert)
    for g, w in zip(got, want):
        assert g.kept_corners == w.kept_corners
        assert g.triangulated_points == w.triangulated_points
        np.testing.assert_allclose(g.reproj_rms_px, w.reproj_rms_px,
                                   atol=SUBPIX_PX)
        assert abs(g.triangulation_rms_mm - w.triangulation_rms_mm) <= 0.05
    assert got[0].triangulation_rms_mm < got[1].triangulation_rms_mm


def test_triangulation_helpers_match():
    rng = np.random.default_rng(3)
    X = np.array([300.0, -150.0, 800.0])
    origins = rng.normal(0, 2000.0, (5, 3))
    dirs = X - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_array_equal(ev.triangulate_rays(origins, dirs),
                                  jev.triangulate_rays(origins, dirs))
    np.testing.assert_array_equal(ev.board_object_points(),
                                  jev.board_object_points())
    pred = rng.normal(0, 1, (48, 2))
    meas = pred + rng.normal(0, 0.1, (48, 2))
    kept = rng.random(48) < 0.7
    assert ev.reprojection_rms(pred, meas, kept) == jev.reprojection_rms(
        pred, meas, kept)
    assert np.isnan(ev.reprojection_rms(pred, meas, np.zeros(48, bool)))


# -- end to end ---------------------------------------------------------------


def test_auto_extrinsics_end_to_end_two_cameras(reference_reader):
    """``chip_smoke``'s phase-20 scene at half resolution with two
    cameras, through both packages (``vbr_tpu`` reading the same arrays
    as its videos): the same blobs, matches, flips and votes, poses within
    the refinement's tolerance, and within the JAX bounds of the committed
    rig up to the global 180° frame."""
    cs = _chip_smoke()
    sc = cs.extrinsics_scene(torch, torch.device(CPU), (243, 322), 2,
                             bg_frames=8)
    for i in range(2):
        reference_reader[f"/rig/cam{i + 1}/checkerboard.avi"] = sc.boards[i]
        reference_reader[f"/rig/cam{i + 1}/background.avi"] = sc.backs[i]
        reference_reader[f"/rig/cam{i + 1}/video.avi"] = sc.person[i][None]
    got = ax.auto_extrinsics(sc.boards, sc.backs, sc.person, sc.cams,
                             photometric_iters=20, device=CPU)
    want = jax_ax.auto_extrinsics("/rig", [_jcam(c) for c in sc.cams],
                                  photometric_iters=20)
    assert got.n_blobs == want.n_blobs and min(got.n_blobs) >= 20
    assert got.n_matched == want.n_matched
    assert got.flips == want.flips and got.votes == want.votes
    np.testing.assert_allclose(got.photometric_mse, want.photometric_mse,
                               rtol=1e-9)
    for a, b in zip(got.cameras, want.cameras):
        assert np.abs(a.rvec - np.asarray(b.rvec)).max() <= REFINE_RAD
        assert np.abs(a.tvec - np.asarray(b.tvec)).max() <= REFINE_MM
    errs, _ = cs.pose_errors(got.cameras, sc.cams)
    assert all(r < 0.01 and t < 25.0 for r, t in errs), errs


def test_auto_extrinsics_raises_without_a_board():
    rng = np.random.default_rng(0)
    bg = rng.integers(80, 170, (40, 60, 3)).astype(np.uint8)
    cams = [tconfig.CameraParams(fx=60.0, fy=60.0, cx=30.0, cy=20.0)]
    with pytest.raises(RuntimeError, match="board region not found"):
        ax.auto_extrinsics([[bg]], [[bg] * 3], None, cams, device=CPU)


@pytest.mark.parametrize("entry", ["largest_change_region",
                                   "resolve_rig_orientation",
                                   "photometric_refine", "hull_coverage"])
def test_extrinsics_entry_points_default_to_the_card(board, entry):
    """No fallback to the CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jcams, masks, _ = jsyn.synthetic_rig(image_hw=(48, 64))
    tcams = [_tcam(c) for c in jcams]
    g = board["gray"]
    call = {
        "largest_change_region": lambda: ax.largest_change_region(
            np.zeros(g.shape + (3,)), np.full(g.shape + (3,), 200, np.uint8)),
        "resolve_rig_orientation": lambda: ax.resolve_rig_orientation(
            tcams, [(c.rvec, c.tvec) for c in tcams], masks),
        "photometric_refine": lambda: ax.photometric_refine(
            g, K_BOARD, DIST_BOARD, board["rv0"], board["tv0"], SQ, iters=1),
        "hull_coverage": lambda: ev.hull_coverage(masks, tcams),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
