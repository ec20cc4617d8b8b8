"""Port parity of the corner-based calibration: ``ops/camera.py``'s
undistortion and homographies (the numpy path exact; f64 tensors within
1e-9 relative for homographies, whose SVD is torch's, and 1e-12 px
elsewhere; differentiable by ``torch.func`` in f64), and
``pipelines/calibration.py`` (``calibrate_camera``, ``solve_pnp``,
``solve_pnp_ransac`` within rtol 1e-6 of ``vbr_tpu`` on
``tests/test_calibration.py``'s synthetic views, noise 0 and 0.3 px; the
same inliers; ``discard_bad_image_points`` the same views) and
``pipelines/validation.py``."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.ops import camera as jcam
from vbr_tpu.pipelines import calibration as jcal
from vbr_tpu.pipelines import validation as jval
from vbr_tpu_torch.ops import camera as tcam
from vbr_tpu_torch.pipelines import calibration as tcal
from vbr_tpu_torch.pipelines import validation as tval

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_calibration as tc  # noqa: E402  (its synthetic views)

RTOL = 1e-6
K_TRUE, DIST_TRUE, BOARD, SQUARE = tc.K_TRUE, tc.DIST_TRUE, tc.BOARD, tc.SQUARE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


# -- camera --------------------------------------------------------------------


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(8)
    src = rng.uniform(0, 9, (48, 2))
    Hw = np.array([[40.0, 3.0, 120.0], [-2.0, 41.0, 80.0], [1e-3, 2e-3, 1.0]])
    dst = jcam.apply_homography(Hw, src, xp=np) + rng.normal(0, 0.3, (48, 2))
    uv = rng.uniform([20, 20], [620, 460], (200, 2))
    return src, dst, uv


def test_numpy_path_is_the_jax_packages_numpy_path(points):
    src, dst, uv = points
    np.testing.assert_array_equal(
        tcam.undistort_points(uv, K_TRUE, DIST_TRUE, 20),
        jcam.undistort_points(uv, K_TRUE, DIST_TRUE, 20, xp=np))
    np.testing.assert_array_equal(tcam._normalization_transform(src),
                                  jcam._normalization_transform(src, xp=np))
    H = jcam.homography_dlt(src, dst, xp=np)
    np.testing.assert_array_equal(tcam.homography_dlt(src, dst), H)
    np.testing.assert_array_equal(tcam.apply_homography(H, src),
                                  jcam.apply_homography(H, src, xp=np))
    np.testing.assert_array_equal(
        tcam.perspective_transform_4pt(src[:4], dst[:4]),
        jcam.perspective_transform_4pt(src[:4], dst[:4], xp=np))


def test_f64_tensors(points):
    src, dst, uv = points
    t = torch.from_numpy
    got = tcam.undistort_points(t(uv), t(K_TRUE), t(DIST_TRUE), 20)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - jcam.undistort_points(
        uv, K_TRUE, DIST_TRUE, 20, xp=np)).max() <= 1e-12
    H = jcam.homography_dlt(src, dst, xp=np)
    close(tcam.homography_dlt(t(src), t(dst)).numpy(), H, rtol=1e-9)
    assert np.abs(tcam.apply_homography(t(H), t(src)).numpy()
                  - jcam.apply_homography(H, src, xp=np)).max() <= 1e-12
    P = jcam.perspective_transform_4pt(src[:4], dst[:4], xp=np)
    close(tcam.perspective_transform_4pt(t(src[:4]), t(dst[:4])).numpy(), P,
          rtol=1e-9)


def test_tensors_keep_their_dtype(points):
    src, dst, uv = points
    f32 = {"dtype": torch.float32}
    assert tcam.homography_dlt(torch.tensor(src, **f32),
                               torch.tensor(dst, **f32)).dtype == torch.float32
    assert tcam.undistort_points(torch.tensor(uv, **f32),
                                 torch.tensor(K_TRUE, **f32),
                                 torch.tensor(DIST_TRUE, **f32)).dtype \
        == torch.float32


def test_projection_jacobian_under_torch_func():
    """``project_points`` in f64 under ``torch.func.jacfwd`` over a
    ``vmap`` of poses: the Jacobian of ``vbr_tpu``'s x64 ``jax.jacfwd``."""
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    poses = np.array([[0.1, -0.2, 0.05, -300.0, -200.0, 2500.0],
                      [-0.3, 0.25, 0.1, 100.0, -50.0, 3000.0]])

    def t_fn(p):
        return torch.func.vmap(lambda q: tcam.project_points(
            torch.from_numpy(obj), q[:3], q[3:], torch.from_numpy(K_TRUE),
            torch.from_numpy(DIST_TRUE)))(p)

    got = torch.func.jacfwd(t_fn)(torch.from_numpy(poses))
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = jax.jacfwd(lambda p: jax.vmap(lambda q: jcam.project_points(
            jnp.asarray(obj), q[:3], q[3:], jnp.asarray(K_TRUE),
            jnp.asarray(DIST_TRUE)))(p))(jnp.asarray(poses))
        want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()


# -- calibration ---------------------------------------------------------------


@pytest.fixture(scope="module")
def views():
    """``tests/test_calibration.py``'s synthetic views, noise 0 and 0.3
    px, with ``vbr_tpu``'s calibration of each."""
    out = {}
    for noise, n in ((0.0, 8), (0.3, 10)):
        _, pts, rvecs, tvecs = tc.synth_views(n, noise=noise)
        out[noise] = (pts, rvecs, tvecs,
                      jcal.calibrate_camera(pts, (644, 486), BOARD, SQUARE))
    return out


def test_closed_form_start_is_exact(views):
    pts = views[0.3][0]
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    np.testing.assert_array_equal(obj, jcal.chessboard_object_points(BOARD,
                                                                      SQUARE))
    Hs = tcal._homographies(obj[:, :2], pts)
    for a, b in zip(Hs, jcal._homographies(obj[:, :2], pts)):
        np.testing.assert_array_equal(a, b)
    K0 = tcal.zhang_intrinsic_init(Hs, (644, 486))
    np.testing.assert_array_equal(K0, jcal.zhang_intrinsic_init(Hs,
                                                                (644, 486)))
    for H in Hs:
        for a, b in zip(tcal.pose_from_homography(H, K0),
                        jcal.pose_from_homography(H, K0)):
            np.testing.assert_array_equal(a, b)
    # too few constraints: both fall back to the same centred guess
    np.testing.assert_array_equal(tcal.zhang_intrinsic_init(Hs[:1], (644, 486)),
                                  jcal.zhang_intrinsic_init(Hs[:1], (644, 486)))


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_calibrate_camera(views, noise):
    pts, _, _, want = views[noise]
    got = tcal.calibrate_camera(pts, (644, 486), BOARD, SQUARE, device="cpu")
    assert [f for f in vars(got)] == [f for f in vars(want)]
    close(got.K, want.K)
    close(got.dist, want.dist)
    close(np.stack(got.rvecs), np.stack(want.rvecs))
    close(np.stack(got.tvecs), np.stack(want.tvecs))
    close(got.rms, want.rms)
    close(got.per_view_errors, want.per_view_errors)
    close(got.intrinsic_std, want.intrinsic_std)


def test_calibrate_camera_meets_the_jax_packages_bounds(views):
    """``tests/test_calibration.py``'s recovery bounds, on the port."""
    pts, rvecs, tvecs, _ = views[0.0]
    res = tcal.calibrate_camera(pts, (644, 486), BOARD, SQUARE, device="cpu")
    assert res.rms < 1e-4
    np.testing.assert_allclose(res.K, K_TRUE, atol=0.05)
    np.testing.assert_allclose(res.dist, DIST_TRUE, atol=1e-3)
    for i in range(len(pts)):
        np.testing.assert_allclose(res.rvecs[i], rvecs[i], atol=1e-3)
        np.testing.assert_allclose(res.tvecs[i], tvecs[i], atol=1.0)
    res = tcal.calibrate_camera(views[0.3][0], (644, 486), BOARD, SQUARE,
                                device="cpu")
    assert res.per_view_errors.shape == (10,)
    assert 0.1 < res.per_view_errors.mean() < 1.5
    assert np.isfinite(res.intrinsic_std[:4]).all()


def test_lm_steps_past_a_singular_system():
    """A parameter the residuals do not depend on makes every damped system
    singular: torch raises where JAX returns non-finite values, and both
    end in ``lam *= 10`` and stop with the parameter where it started."""
    target = np.array([3.0, -2.0, 0.5])

    def jfn(p):
        return jnp.stack([p[0] - target[0], p[1] - target[1],
                          (p[0] * p[1]) - target[0] * target[1]])

    def tfn(p):
        return torch.stack([p[0] - target[0], p[1] - target[1],
                            (p[0] * p[1]) - target[0] * target[1]])

    p0 = np.array([1.0, 1.0, 7.0])
    with jax.enable_x64(True):
        want = jcal._levenberg_marquardt(jfn, p0)
    got = tcal._levenberg_marquardt(tfn, p0, torch.device("cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)
    assert got[0][2] == 7.0


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_solve_pnp(noise):
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    rvec, tvec = np.array([-1.2, 0.5, 0.6]), np.array([240.0, 700.0, 4700.0])
    uv = jcam.project_points(obj, rvec, tvec, K_TRUE, DIST_TRUE, xp=np)
    uv = uv + np.random.default_rng(9).normal(0, noise, uv.shape)
    got = tcal.solve_pnp(obj, uv, K_TRUE, DIST_TRUE, device="cpu")
    want = jcal.solve_pnp(obj, uv, K_TRUE, DIST_TRUE)
    close(got[0], want[0])
    close(got[1], want[1])


@pytest.mark.parametrize("n_out,seed", [(8, 0), (16, 1), (0, 2)])
def test_solve_pnp_ransac(n_out, seed):
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    rvec, tvec = np.array([-1.2, 0.5, 0.6]), np.array([240.0, 700.0, 4700.0])
    uv = jcam.project_points(obj, rvec, tvec, K_TRUE, DIST_TRUE, xp=np)
    rng = np.random.default_rng(seed)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    out = rng.choice(len(uv), n_out, replace=False)
    uv[out] += rng.uniform(40, 90, (n_out, 2))
    got = tcal.solve_pnp_ransac(obj, uv, K_TRUE, DIST_TRUE, seed=seed,
                                device="cpu")
    want = jcal.solve_pnp_ransac(obj, uv, K_TRUE, DIST_TRUE, seed=seed)
    np.testing.assert_array_equal(got[2], want[2])
    close(got[0], want[0])
    close(got[1], want[1])
    assert not got[2][out].any()
    np.testing.assert_allclose(got[0], rvec, atol=1e-2)


def test_discard_bad_image_points():
    _, pts, _, _ = tc.synth_views(5, noise=0.1)
    pts[3] = pts[3] + np.random.default_rng(3).normal(
        0, 3.0, pts[3].shape).astype(np.float32)
    got = tcal.discard_bad_image_points(pts, (644, 486), BOARD, SQUARE, 0.15,
                                        device="cpu")
    want = jcal.discard_bad_image_points(pts, (644, 486), BOARD, SQUARE, 0.15)
    assert got[1] == want[1] and got[3] == want[3] == [3]


def test_results_cross_between_the_packages(views):
    """A JAX calibration's K and poses start the port's PnP and vice versa:
    the numpy fields are interchangeable."""
    pts, _, _, jres = views[0.3]
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    a = tcal.solve_pnp(obj, pts[0], jres.K, jres.dist, device="cpu")
    b = jcal.solve_pnp(obj, pts[0], jres.K, jres.dist)
    close(a[0], b[0])
    close(a[1], b[1])


# -- validation ---------------------------------------------------------------


def test_validation_drawings_and_reprojection_error():
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    rvec, tvec = np.array([0.2, -0.3, 0.1]), np.array([-300.0, -200.0, 2600.0])
    uv = jcam.project_points(obj, rvec, tvec, K_TRUE, DIST_TRUE, xp=np)
    for name in ("draw_axes", "draw_cube"):
        a = np.zeros((486, 644, 3), np.uint8)
        b = a.copy()
        getattr(tval, name)(a, K_TRUE, DIST_TRUE, rvec, tvec)
        getattr(jval, name)(b, K_TRUE, DIST_TRUE, rvec, tvec)
        np.testing.assert_array_equal(a, b)
        assert a.any()
    a = np.zeros((486, 644, 3), np.uint8)
    b = a.copy()
    tval.draw_chessboard_corners(a, uv, BOARD)
    jval.draw_chessboard_corners(b, uv, BOARD)
    np.testing.assert_array_equal(a, b)
    noisy = uv + np.random.default_rng(2).normal(0, 0.5, uv.shape)
    assert tval.reprojection_error(obj, noisy, K_TRUE, DIST_TRUE, rvec,
                                   tvec) == jval.reprojection_error(
        obj, noisy, K_TRUE, DIST_TRUE, rvec, tvec)


@pytest.mark.parametrize("call", ["calibrate_camera", "solve_pnp",
                                  "solve_pnp_ransac", "discard"])
def test_cuda_without_a_card_raises(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    obj = tcal.chessboard_object_points(BOARD, SQUARE)
    uv = jcam.project_points(obj, np.array([0.1, 0.2, 0.0]),
                             np.array([0.0, 0.0, 3000.0]), K_TRUE, DIST_TRUE,
                             xp=np)
    fn = {"calibrate_camera": lambda: tcal.calibrate_camera(
              [uv] * 3, (644, 486), BOARD, SQUARE),
          "solve_pnp": lambda: tcal.solve_pnp(obj, uv, K_TRUE, DIST_TRUE),
          "solve_pnp_ransac": lambda: tcal.solve_pnp_ransac(
              obj, uv, K_TRUE, DIST_TRUE),
          "discard": lambda: tcal.discard_bad_image_points(
              [uv] * 3, (644, 486), BOARD, SQUARE)}[call]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
