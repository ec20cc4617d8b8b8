"""Port parity of the detector-free photometric calibration
(``pipelines/photometric_calibration.py``) on the JAX package's fixture
(``tests/test_photometric_calibration.py``: six boards rendered through the
full camera model at 320×240): the host stages and ``board_view_from_frame``
exact, the blob labels (``scipy.ndimage.label``) equal to ``vbr_tpu``'s
two-pass labeller, the loss and gradient at the warm start (loss rtol 1e-5,
gradient within 1e-3 of each parameter group's largest), a short staged fit
(loss curve rtol 1e-3, K within 0.05 px, over the steps the reference
itself reproduces), and the JAX package's recovery and ``fix_pp`` bounds
run on the port.

``vbr_tpu``'s objective is a closure inside ``photometric_calibrate``; the
tests take it from the ``jax.value_and_grad`` call there."""

import functools
import os
import sys

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.pipelines import auto_extrinsics as jauto
from vbr_tpu.pipelines import calibration as jcal
from vbr_tpu.pipelines import photometric_calibration as jpc
from vbr_tpu_torch.pipelines import calibration as tcal
from vbr_tpu_torch.pipelines import photometric_calibration as tpc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_photometric_calibration as fx  # noqa: E402  (its fixture)

PATTERN, SQUARE, SIZE = fx.PATTERN, fx.SQUARE, (fx.IMG_W, fx.IMG_H)
SHORT_STAGES = [(30, "nuisance"), (60, "all")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return [fx.render_board(fx.K_TRUE, fx.DIST_TRUE, rv, tv)
            for rv, tv in fx._poses()]


@pytest.fixture(scope="module")
def views(frames):
    """The port's views (no de-overlay, as the JAX tests) and the port's
    corner-LM warm start from them."""
    vs = [tpc.board_view_from_frame(f, i, PATTERN, deoverlay=False)
          for i, f in enumerate(frames)]
    vs = [v for v in vs if v is not None]
    init = tcal.calibrate_camera([v.corners for v in vs], SIZE, PATTERN,
                                 SQUARE, device="cpu")
    return vs, (init.K, np.asarray(init.dist).reshape(-1)[:5].copy(),
                list(zip(init.rvecs, init.tvecs))), init


def jax_objective(views, init, samples_per_square, **kw):
    """``vbr_tpu``'s loss closure for ``views`` and ``init`` (taken from its
    ``jax.value_and_grad`` call; no step is run)."""
    seen = {}
    real = jax.value_and_grad

    def spy(f, *a, **k):
        seen["loss"] = f
        return real(f, *a, **k)

    jax.value_and_grad = spy
    try:
        jpc.photometric_calibrate(
            views, SIZE, pattern=PATTERN, square_mm=SQUARE,
            samples_per_square=samples_per_square, init=init, stages=[],
            device="cpu", **kw)
    finally:
        jax.value_and_grad = real
    return seen["loss"]


# -- labels and host stages ----------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_label_matches_label_host_on_random_masks(seed):
    rng = np.random.default_rng(seed)
    m = rng.random(tuple(rng.integers(1, 70, 2))) < rng.uniform(0.2, 0.8)
    got, n = tpc._label_host(m)
    want, k = jauto._label_host(m)
    assert n == k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(6))
def test_label_matches_label_host_on_rendered_boards(frames, i):
    """The half-resolution eroded dark mask that ``adaptive_dark_blobs``
    labels, on each fixture frame."""
    g = frames[i][..., 0].astype(np.float64)
    dark = g < (jpc._box_mean(g, 63) - 14.0)
    er = (dark & np.roll(dark, 1, 0) & np.roll(dark, -1, 0)
          & np.roll(dark, 1, 1) & np.roll(dark, -1, 1))[::2, ::2]
    got, n = tpc._label_host(er)
    want, k = jauto._label_host(er)
    assert n == k >= 20
    np.testing.assert_array_equal(got, want)
    assert scipy.ndimage.generate_binary_structure(2, 1).sum() == 5


def test_suppress_overlay_exact(frames):
    f = frames[0].copy()
    yy, xx = np.mgrid[0:fx.IMG_H, 0:fx.IMG_W]
    f[(yy - 40) ** 2 + (xx - 40) ** 2 <= 9] = (255, 0, 255)
    f[100:104, 150:190] = (0, 255, 0)
    for a, b in zip(tpc.suppress_overlay(f), jpc.suppress_overlay(f)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(6))
@pytest.mark.parametrize("deoverlay", [False, True])
def test_board_view_from_frame_exact(frames, i, deoverlay):
    a = tpc.board_view_from_frame(frames[i], i, PATTERN, deoverlay=deoverlay)
    b = jpc.board_view_from_frame(frames[i], i, PATTERN, deoverlay=deoverlay)
    assert (a is None) == (b is None)
    assert [f for f in vars(a)] == [f for f in vars(b)]
    for f in vars(b):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_blobs_and_lattice_exact(frames):
    g = frames[2][..., 0].astype(np.float32)
    cents = tpc.adaptive_dark_blobs(g, area_range=(40, 6000))
    np.testing.assert_array_equal(
        cents, jpc.adaptive_dark_blobs(g, area_range=(40, 6000)))
    H, nm = tpc.grow_black_lattice(cents, PATTERN)
    Hj, nmj = jpc.grow_black_lattice(cents, PATTERN)
    np.testing.assert_array_equal(H, Hj)
    assert nm == nmj >= 24


def test_collect_board_views_takes_frames_and_refuses_a_path(frames,
                                                             tmp_path):
    """Frames or a video path (here an uncompressed AVI of the same frames,
    read back exactly) give the same views; a missing path raises."""
    from vbr_tpu_torch.utils import video as tvio

    got = tpc.collect_board_views(iter(frames), PATTERN, frame_step=2,
                                  max_views=2, deoverlay=False)
    want = [jpc.board_view_from_frame(frames[i], i, PATTERN, deoverlay=False)
            for i in (0, 2)]
    assert [v.frame_idx for v in got] == [0, 2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.H, b.H)
    path = str(tmp_path / "intrinsics.avi")
    h, w = frames[0].shape[:2]
    with tvio.AviWriter(path, 10.0, w, h, fourcc="BI_RGB") as sink:
        for f in frames[:3]:
            sink.write(f)
    from_path = tpc.collect_board_views(path, PATTERN, frame_step=2,
                                        max_views=2, deoverlay=False)
    assert [v.frame_idx for v in from_path] == [0, 2]
    for a, b in zip(from_path, got):
        np.testing.assert_array_equal(a.H, b.H)
    missing = str(tmp_path / "cam1" / "intrinsics.avi")
    for call in (tpc.collect_board_views, functools.partial(
            tpc.calibrate_video_photometric, device="cpu")):
        with pytest.raises(FileNotFoundError, match="cannot open video"):
            call(missing)


# -- the objective -------------------------------------------------------------


@pytest.mark.parametrize("spp,pixel_sigma", [(8, True), (10, True),
                                             (8, False)])
def test_loss_and_gradient_at_the_warm_start(views, spp, pixel_sigma):
    vs, init, _ = views
    prob = tpc.PhotometricProblem(vs, SIZE, PATTERN, SQUARE, spp, init=init,
                                  pixel_sigma=pixel_sigma, device="cpu")
    loss = jax_objective(vs, init, spp, pixel_sigma=pixel_sigma)
    (Lj, mse_j), gj = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(prob.p0))
    gj = np.asarray(gj)
    L, g = prob.value_and_grad()
    assert abs(L / float(Lj) - 1) <= 1e-5
    F = prob.F
    for s in (slice(0, 4), slice(4, 9), slice(9, 9 + 6 * F),
              slice(9 + 6 * F, None)):
        assert np.abs(g[s] - gj[s]).max() <= 1e-3 * np.abs(gj[s]).max()
    _, mse = prob.loss(torch.from_numpy(prob.p0))
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_j), rtol=1e-5)


@pytest.fixture(scope="module")
def short_fits(views):
    """The short fit at 8 samples per square in both packages, and
    ``vbr_tpu``'s again from fx moved by 1e-7 of itself (about one f32
    ulp)."""
    vs, init, _ = views
    kw = dict(pattern=PATTERN, square_mm=SQUARE, samples_per_square=8,
              stages=SHORT_STAGES, device="cpu")
    K1 = init[0].copy()
    K1[0, 0] *= 1 + 1e-7
    return (tpc.photometric_calibrate(vs, SIZE, init=init, **kw),
            jpc.photometric_calibrate(vs, SIZE, init=init, **kw),
            jpc.photometric_calibrate(vs, SIZE, init=(K1,) + init[1:], **kw))


STABLE_STEPS = 40  # the nuisance stage and the first 10 steps of "all"


def test_short_fit_matches_where_the_reference_reproduces_itself(short_fits):
    """Loss curve within rtol 1e-3 and K within 0.05 px over the steps
    where ``vbr_tpu`` moved by one ulp stays within 1e-4 of itself."""
    got, want, nudged = short_fits
    assert got.loss_curve.shape == want.loss_curve.shape == (90,)
    n = STABLE_STEPS
    self_gap = np.abs(nudged.loss_curve[:n] / want.loss_curve[:n] - 1).max()
    assert self_gap <= 1e-4
    assert np.abs(got.loss_curve[:n] / want.loss_curve[:n] - 1).max() <= 1e-3
    np.testing.assert_array_equal(got.frame_indices, want.frame_indices)


def test_short_fit_beyond_is_below_the_references_own_sensitivity(short_fits):
    """Past ~20 geometry steps the staged Adam fit amplifies rounding: a
    1e-7 change of the start moves ``vbr_tpu``'s own loss curve by more
    than 1e-3 and its K by more than 0.05 px, so no implementation that
    is not XLA's bit for bit can hold the full 90 steps to that tolerance
    (ROADMAP Queue 3).  The port stays within the reference's own
    spread there."""
    got, want, nudged = short_fits
    self_gap = np.abs(nudged.loss_curve / want.loss_curve - 1).max()
    self_k = np.abs(nudged.K - want.K).max()
    assert self_gap > 1e-3 and self_k > 0.05
    assert np.abs(got.loss_curve / want.loss_curve - 1).max() <= 10 * self_gap
    assert np.abs(got.K - want.K).max() <= 10 * self_k + 0.05


def test_short_fit_k_within_005_px_on_the_stable_steps(views):
    vs, init, _ = views
    kw = dict(pattern=PATTERN, square_mm=SQUARE, samples_per_square=8,
              stages=[(30, "nuisance"), (STABLE_STEPS - 30, "all")],
              init=init, device="cpu")
    got = tpc.photometric_calibrate(vs, SIZE, **kw)
    want = jpc.photometric_calibrate(vs, SIZE, **kw)
    assert np.abs(got.K - want.K).max() <= 0.05
    np.testing.assert_allclose(got.loss_curve, want.loss_curve, rtol=1e-3)
    np.testing.assert_allclose(got.mse, want.mse, rtol=1e-3)


# -- the JAX package's own bounds, run on the port -----------------------------


def test_photometric_calibrate_recovers_intrinsics(views):
    """``tests/test_photometric_calibration.py``'s recovery test."""
    vs, init_t, init = views
    assert len(vs) >= 5
    torch.set_num_threads(2)  # 2000 eager steps: the file's longest test
    try:
        res = tpc.photometric_calibrate(
            vs, SIZE, pattern=PATTERN, square_mm=SQUARE, iters=0, chunk=500,
            samples_per_square=10, init=init_t,
            stages=[(400, "nuisance"), (1600, "all")], device="cpu")
    finally:
        torch.set_num_threads(1)
    K = fx.K_TRUE
    assert abs(res.K[0, 0] - K[0, 0]) / K[0, 0] < 0.01
    assert abs(res.K[1, 1] - K[1, 1]) / K[1, 1] < 0.01
    assert abs(res.K[0, 2] - K[0, 2]) < 2.5
    assert abs(res.K[1, 2] - K[1, 2]) < 2.5
    err_photo = fx._radial_curve_err_px(res.dist, rmax=0.4)
    err_init = fx._radial_curve_err_px(np.asarray(init.dist)[:5], rmax=0.4)
    assert err_photo < 0.8
    assert err_photo < 0.25 * err_init


def test_photometric_calibrate_fix_pp_pins_principal_point(views):
    vs, init_t, _ = views
    pin = (fx.K_TRUE[0, 2] + 3.0, fx.K_TRUE[1, 2] - 2.0)
    res = tpc.photometric_calibrate(
        vs, SIZE, pattern=PATTERN, square_mm=SQUARE, iters=0, chunk=100,
        samples_per_square=8, fix_pp=pin, init=init_t,
        stages=[(100, "nuisance"), (200, "all")], device="cpu")
    assert res.K[0, 2] == pytest.approx(pin[0], abs=1e-6)
    assert res.K[1, 2] == pytest.approx(pin[1], abs=1e-6)
    assert abs(res.K[0, 0] - fx.K_TRUE[0, 0]) / fx.K_TRUE[0, 0] < 0.05


def test_calibrate_video_photometric_end_to_end(frames):
    """The entry point over the frames as an iterable (collection, warm
    start, staged fit); few steps: the plumbing, with the JAX test's
    bounds."""
    res, vs = tpc.calibrate_video_photometric(
        iter(frames), pattern=PATTERN, square_mm=SQUARE, iters=60, chunk=30,
        deoverlay=False, samples_per_square=8, device="cpu")
    assert len(vs) >= 5
    assert res.rvecs.shape == (len(vs), 3)
    assert res.loss_curve.shape == (60,)
    assert abs(res.K[0, 0] - fx.K_TRUE[0, 0]) / fx.K_TRUE[0, 0] < 0.10
    assert abs(res.K[1, 2] - fx.K_TRUE[1, 2]) < 12.0
    assert [f for f in vars(res)] == [
        f.name for f in jpc.PhotoCalibResult.__dataclass_fields__.values()]


def test_jax_views_and_warm_start_feed_the_port(frames):
    """Views made by ``vbr_tpu`` and its warm start give the port's problem
    the same start as the port's own."""
    jv = [jpc.board_view_from_frame(f, i, PATTERN, deoverlay=False)
          for i, f in enumerate(frames[:4])]
    jinit = jcal.calibrate_camera([v.corners for v in jv], SIZE, PATTERN,
                                  SQUARE)
    init = (jinit.K, np.asarray(jinit.dist)[:5].copy(),
            list(zip(jinit.rvecs, jinit.tvecs)))
    a = tpc.PhotometricProblem(jv, SIZE, PATTERN, SQUARE, 8, init=init,
                               device="cpu")
    tv = [tpc.board_view_from_frame(f, i, PATTERN, deoverlay=False)
          for i, f in enumerate(frames[:4])]
    b = tpc.PhotometricProblem(tv, SIZE, PATTERN, SQUARE, 8, init=init,
                               device="cpu")
    np.testing.assert_array_equal(a.p0, b.p0)
    np.testing.assert_array_equal(a.sup.numpy(), b.sup.numpy())


def test_graph_route_and_cuda_need_a_card(views):
    vs, init, _ = views
    prob = tpc.PhotometricProblem(vs, SIZE, PATTERN, SQUARE, 4, init=init,
                                  device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        prob.run([(1, "all")], route="graph")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpc.photometric_calibrate(vs, SIZE, PATTERN, SQUARE, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpc.calibrate_video_photometric(iter([]))
