"""Port parity of the chessboard corner path: ``ops/color.py``'s gray,
equalization and thresholds (exact against ``vbr_tpu`` run op by op under
``jax.disable_jit()``; the jitted build contracts multiply-adds), and
``ops/corners.py``: the saddle response (within 1e-5 of the map's maximum
against jitted ``vbr_tpu``, exact under ``jax.disable_jit()``), the top-k
candidates (equal, ties included), ``corner_subpix`` and
``detect_chessboard`` (within 1e-3 px, the same views returning None) on
``tests/test_corners.py``'s rendered boards and on a board rendered at a
real camera's pose, and the manual-corner helpers."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.ops import color as jcolor
from vbr_tpu.ops import corners as jcorners
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops import corners as tcorners

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_corners  # noqa: E402  (its rendered boards)

PX = 1e-3  # corner tolerance, px


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boards():
    """Gray u8 images and their true inner corners: the synthetic board,
    the rotated one (``tests/test_corners.py``), noise, and a board
    rendered at one of camera 2's real calibration poses (644×486, its
    fitted K and distortion, 115 mm squares)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    out = {"synthetic": test_corners.render_chessboard()}
    Hw = np.array([[0.97, -0.26, 320], [0.25, 0.96, 60], [3e-5, 1e-5, 1]])
    out["rotated"] = test_corners.render_chessboard(H_warp=Hw)
    out["noise"] = (np.random.default_rng(5).integers(
        0, 255, size=(200, 300), dtype=np.uint8), None)
    K, dist, rv, tv = chip_smoke.calib_truth(2, chip_smoke.CALIB_HW)
    frames = chip_smoke.render_boards(torch, torch.device("cpu"), K, dist,
                                      rv[1:4:2], tv[1:4:2],
                                      chip_smoke.CALIB_HW)
    truth = chip_smoke.true_corners(K, dist, rv[1:4:2], tv[1:4:2])
    out["real pose"] = (frames[0, ..., 0].copy(), truth[0])
    # a pose that neither package's detector finds the board in
    out["real pose, not found"] = (frames[1, ..., 0].copy(), truth[1])
    return out


@pytest.fixture(scope="module")
def jax_detections(boards):
    return {k: jcorners.detect_chessboard(img, (8, 6))
            for k, (img, _) in boards.items()}


# -- colour ------------------------------------------------------------------


def _all_colours():
    v = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    return np.stack([b, g, r], -1).reshape(4096, 4096, 3)


def test_bgr_to_gray_exact_on_every_colour():
    """All 2^24 BGR colours: equal to ``vbr_tpu`` run op by op; the jitted
    build fuses the weights into multiply-adds and rounds 1166 colours to
    the other side of a half."""
    bgr = _all_colours()
    got = tcolor.bgr_to_gray_u8(torch.from_numpy(bgr)).numpy()
    with jax.disable_jit():
        want = np.asarray(jcolor.bgr_to_gray_u8(jnp.asarray(bgr)))
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(jcolor.bgr_to_gray_u8(jnp.asarray(bgr)))
    assert int((jitted != got).sum()) < 2000
    assert int(np.abs(jitted.astype(int) - got).max()) <= 1


@pytest.mark.parametrize("shape,lo,hi", [((486, 644), 0, 256),
                                         ((240, 320), 100, 140),
                                         ((7, 9), 200, 203), ((1, 1), 5, 6)])
def test_equalize_hist_exact(shape, lo, hi):
    g = np.random.default_rng(hi).integers(lo, hi, shape).astype(np.uint8)
    got = tcolor.equalize_hist_u8(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcolor.equalize_hist_u8(jnp.asarray(g))))


@pytest.mark.parametrize("thresh,maxval", [(127, 255), (127.5, 200),
                                           (0, 1), (254.9, 255)])
def test_thresholds_exact(thresh, maxval):
    g = np.random.default_rng(1).integers(0, 256, (33, 47)).astype(np.uint8)
    for tf, jf in ((tcolor.threshold_binary, jcolor.threshold_binary),
                   (tcolor.threshold_binary_inv,
                    jcolor.threshold_binary_inv)):
        got = tf(torch.from_numpy(g), thresh, maxval).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jf(jnp.asarray(g), thresh, maxval)))


# -- saddle response, candidates -------------------------------------------


@pytest.mark.parametrize("name", ["synthetic", "rotated", "real pose",
                                  "noise"])
def test_saddle_response(boards, name):
    img = boards[name][0]
    got = tcorners.saddle_response(img, device="cpu").numpy()
    want = np.asarray(jcorners.saddle_response(jnp.asarray(img)))
    assert np.abs(got - want).max() <= 1e-5 * want.max()
    with jax.disable_jit():
        exact = np.asarray(jcorners.saddle_response(jnp.asarray(img)))
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("name", ["synthetic", "real pose"])
def test_top_corner_candidates_equal(boards, name):
    resp = np.array(jcorners.saddle_response(jnp.asarray(boards[name][0])))
    for k in (48, 512):
        xy, score = tcorners.top_corner_candidates(torch.from_numpy(resp), k)
        jxy, jscore = jcorners.top_corner_candidates(jnp.asarray(resp), k)
        np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_corner_candidates_break_ties_by_index(seed):
    """A response symmetric about both axes (equal scores at mirrored
    peaks), integer plateaus, and more candidates asked for than there are
    peaks: the order is (−score, flat index), as ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (20, 31)).astype(np.float32)
    q *= rng.random(q.shape) < 0.4
    resp = np.block([[q, q[:, ::-1]], [q[::-1], q[::-1, ::-1]]])
    for k in (5, 64, resp.size):
        xy, score = tcorners.top_corner_candidates(torch.from_numpy(resp), k)
        jxy, jscore = jcorners.top_corner_candidates(jnp.asarray(resp), k)
        np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    s = score.numpy()
    assert len(set(s[s > 0].tolist())) < int((s > 0).sum())  # ties present


# -- corner_subpix -------------------------------------------------------------


@pytest.mark.parametrize("name,win", [("synthetic", (11, 11)),
                                      ("rotated", (11, 11)),
                                      ("real pose", (11, 11)),
                                      ("synthetic", (5, 5))])
def test_corner_subpix(boards, name, win):
    img, truth = boards[name]
    init = (truth + np.random.default_rng(3).uniform(-2, 2, truth.shape)
            ).astype(np.float32)
    got = tcorners.corner_subpix(img, init, win, device="cpu").numpy()
    want = np.asarray(jcorners.corner_subpix(jnp.asarray(img),
                                             jnp.asarray(init), win))
    assert np.abs(got - want).max() <= PX


def test_corner_subpix_freezes_each_corner_where_its_loop_ends(boards):
    """The batch equals each corner refined alone, and its iteration count
    is where that corner's loop stopped: the update under eps² applied,
    or ``max_iters``."""
    img, truth = boards["synthetic"]
    init = (truth + np.random.default_rng(4).uniform(-3, 3, truth.shape)
            ).astype(np.float32)
    for max_iters, eps in ((30, 0.1), (3, 0.1), (30, 1e-4)):
        q, iters = tcorners.corner_subpix(img, init, (11, 11), max_iters,
                                          eps, return_iters=True,
                                          device="cpu")
        for i in range(0, len(init), 7):
            qi, ni = tcorners.corner_subpix(img, init[i:i + 1], (11, 11),
                                            max_iters, eps,
                                            return_iters=True, device="cpu")
            np.testing.assert_array_equal(q[i].numpy(), qi[0].numpy())
            assert int(iters[i]) == int(ni[0])
        assert int(iters.max()) <= max_iters
        want = np.asarray(jcorners.corner_subpix(
            jnp.asarray(img), jnp.asarray(init), (11, 11), max_iters, eps))
        assert np.abs(q.numpy() - want).max() <= PX
    assert int(iters.min()) > 3  # eps 1e-4: some corners ran on


# -- detect_chessboard ---------------------------------------------------------


@pytest.mark.parametrize("name", ["synthetic", "rotated", "real pose",
                                  "real pose, not found", "noise"])
def test_detect_chessboard(boards, jax_detections, name):
    img, truth = boards[name]
    got = tcorners.detect_chessboard(img, (8, 6), device="cpu")
    want = jax_detections[name]
    assert (got is None) == (want is None)
    if want is None:
        assert name in ("noise", "real pose, not found")
        return
    assert got.shape == (48, 2)
    assert np.abs(got - want).max() <= PX
    d = np.linalg.norm(got[:, None] - truth[None], axis=-1).min(1)
    assert d.mean() < 0.6


def test_detect_chessboard_takes_a_tensor_where_it_lies(boards):
    img = boards["synthetic"][0]
    a = tcorners.detect_chessboard(torch.from_numpy(img), device="cuda")
    b = tcorners.detect_chessboard(img, device="cpu")
    np.testing.assert_array_equal(a, b)


# -- the manual-corner path ---------------------------------------------------


@pytest.mark.parametrize("outer", [True, False])
def test_interpolate_image_points_from_corners(outer):
    quad = np.array([[420.0, 80.0], [90.0, 95.0], [110.0, 380.0],
                     [450.0, 360.0]])
    got = tcorners.interpolate_image_points_from_corners(quad, (8, 6), outer)
    want = jcorners.interpolate_image_points_from_corners(quad, (8, 6), outer)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcorners.sort_corners_clockwise(quad),
                                  jcorners.sort_corners_clockwise(quad))


@pytest.mark.parametrize("with_mask", [False, True])
def test_extract_board_quad(boards, with_mask):
    g = boards["synthetic"][0]
    bgr = np.stack([g, g, g], -1)
    mask = None
    if with_mask:
        mask = np.zeros(g.shape, np.uint8)
        mask[40:450, 60:600] = 1
    got = tcorners.extract_board_quad(bgr, mask, device="cpu")
    want = jcorners.extract_board_quad(bgr, mask)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call", ["saddle_response", "corner_subpix",
                                  "detect_chessboard", "extract_board_quad"])
def test_cuda_without_a_card_raises(call):
    img = np.zeros((40, 50), np.uint8)
    fn = {"saddle_response": lambda: tcorners.saddle_response(img),
          "corner_subpix": lambda: tcorners.corner_subpix(
              img, np.zeros((1, 2), np.float32)),
          "detect_chessboard": lambda: tcorners.detect_chessboard(img),
          "extract_board_quad": lambda: tcorners.extract_board_quad(
              np.zeros((40, 50, 3), np.uint8))}[call]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
