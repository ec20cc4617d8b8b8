"""``vbr_tpu_torch/apps/manual_corners.py`` against
``vbr_tpu/apps/manual_corners.py`` on the CPU.

Without refinement the session (its click/undo flow and its lattice, f64
on the host) equals ``vbr_tpu``'s exactly; with it (``corner_subpix`` in
f32, ``vbr_tpu`` through JAX) the lattice is within 1e-3 px of
``vbr_tpu``'s, the bound of the port's corner tests.  The overlay the
window shows equals ``cv2.circle(..., -1)``'s pixels (cv2 only here, on
the test side).  ``run_interactive``'s event handling runs against a stub
glfw module and a stub ``OpenGL.GL``; without glfw it raises
``ImportError``."""

import sys
import types

import cv2
import numpy as np
import pytest
import torch

from vbr_tpu.apps import manual_corners as jmc
from vbr_tpu_torch.apps import manual_corners as tmc

import test_photometric_calibration as tpc


def _session_pair(gray, clicks, undo_at=None, **kw):
    """Both packages' sessions fed the same clicks (an undo after click
    ``undo_at``) → (vbr_tpu's, the port's)."""
    j = jmc.ManualCornerSession(gray, (8, 6), **kw)
    t = tmc.ManualCornerSession(gray, (8, 6), device="cpu", **kw)
    for k, (x, y) in enumerate(clicks):
        for s in (j, t):
            s.click(x, y)
        if k == undo_at:
            for s in (j, t):
                s.undo()
                assert not s.done
    return j, t


def test_click_flow_equals_vbr_tpu():
    """``tests/test_model_and_artifacts.py``'s flow: the same states after
    every event and the same lattice, bit for bit."""
    gray = np.full((300, 400), 128, np.uint8)
    j = jmc.ManualCornerSession(gray, (8, 6), refine=False)
    t = tmc.ManualCornerSession(gray, (8, 6), refine=False, device="cpu")
    for event in [("click", 40, 30), ("click", 360, 30), ("undo",),
                  ("click", 361, 31), ("click", 361, 271),
                  ("undo",), ("undo",), ("undo",), ("undo",),
                  ("click", 40, 30), ("click", 361, 31), ("click", 361, 271),
                  ("click", 41, 269), ("click", 5, 5)]:
        for s in (j, t):
            getattr(s, event[0])(*event[1:])
        assert j.clicks == t.clicks and j.done == t.done
        assert (j.result is None) == (t.result is None)
    assert t.result.shape == (48, 2) and t.result.dtype == np.float64
    np.testing.assert_array_equal(t.result, j.result)
    assert t.result[:, 0].min() > 40 and t.result[:, 0].max() < 362
    assert t.result[:, 1].min() > 30 and t.result[:, 1].max() < 272


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("outer", [True, False])
def test_lattice_on_perspective_boards_equals_vbr_tpu(seed, outer):
    """Seeded perspective quads clicked in a shuffled order, one click
    undone and made again: the lattice equals ``vbr_tpu``'s exactly."""
    rng = np.random.default_rng(seed)
    quad = np.array([[60, 50], [560, 70], [600, 420], [30, 400]], float)
    quad = quad + rng.uniform(-25, 25, quad.shape)
    clicks = [tuple(p) for p in quad[rng.permutation(4)]]
    clicks.insert(3, (float(rng.uniform(0, 640)), float(rng.uniform(0, 480))))
    gray = rng.integers(0, 256, (480, 640), dtype=np.uint8)
    j, t = _session_pair(gray, clicks, undo_at=3, refine=False,
                         corners_are_outer=outer)
    assert j.done and t.done
    np.testing.assert_array_equal(t.result, j.result)


def test_refined_lattice_within_1e3_px_of_vbr_tpu():
    """Boards rendered at ``tests/test_photometric_calibration.py``'s
    poses without distortion, their outer corners clicked 1-2 px off:
    the refined lattice within 1e-3 px of ``vbr_tpu``'s and within
    0.5 px of the true inner corners (the rendering's own offset reaches
    0.34 px)."""
    from vbr_tpu_torch.ops import camera as cam_ops
    from vbr_tpu_torch.pipelines import calibration as calib

    rng = np.random.default_rng(7)
    cols, rows = tpc.PATTERN
    s = tpc.SQUARE
    outer = np.array([[-s, -s, 0], [cols * s, -s, 0],
                      [cols * s, rows * s, 0], [-s, rows * s, 0]], float)
    inner = calib.chessboard_object_points(tpc.PATTERN, s)
    dist = np.zeros(5)
    worst = 0.0
    for rv, tv in tpc._poses()[:3]:
        frame = tpc.render_board(tpc.K_TRUE, dist, rv, tv)
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        quad = cam_ops.project_points(outer, rv, tv, tpc.K_TRUE, dist)
        off = rng.uniform(1, 2, quad.shape) * rng.choice([-1, 1], quad.shape)
        j, t = _session_pair(gray, [tuple(p) for p in quad + off])
        assert isinstance(t.result, np.ndarray) and t.result.shape == (48, 2)
        worst = max(worst, float(np.abs(t.result - np.asarray(j.result))
                                 .max()))
        truth = cam_ops.project_points(inner, rv, tv, tpc.K_TRUE, dist)
        near = np.linalg.norm(t.result[:, None] - truth[None], axis=-1)
        assert near.min(1).max() < 0.5
    assert worst <= 1e-3


def test_session_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmc.ManualCornerSession(np.zeros((8, 8), np.uint8))


def _cv2_overlay(frame, clicks, result):
    vis = frame.copy()
    for x, y in clicks:
        cv2.circle(vis, (int(x), int(y)), 4, (0, 0, 255), -1)
    if result is not None:
        for x, y in result:
            cv2.circle(vis, (int(x), int(y)), 2, (0, 255, 0), -1)
    return vis


@pytest.mark.parametrize("H, W", [(20, 23), (9, 7)])
def test_overlay_equals_cv2_circle(H, W):
    """Every centre of a grid reaching 6 px past each edge, as a click (red,
    radius 4) and as a lattice point (green, radius 2), with fractional
    and negative coordinates truncated as ``int()`` does."""
    rng = np.random.default_rng(H)
    frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    for cy in range(-6, H + 6):
        for cx in range(-6, W + 6):
            x, y = cx + 0.7, cy - 0.3
            for clicks, result in ((((x, y),), None),
                                   ((), np.array([[x, y]]))):
                np.testing.assert_array_equal(
                    tmc._overlay(frame, clicks, result),
                    _cv2_overlay(frame, clicks, result))
    clicks = [tuple(p) for p in rng.uniform(-3, max(H, W) + 3, (4, 2))]
    lattice = rng.uniform(-3, max(H, W) + 3, (48, 2))
    np.testing.assert_array_equal(tmc._overlay(frame, clicks, lattice),
                                  _cv2_overlay(frame, clicks, lattice))


class _StubGlfw(types.ModuleType):
    """Just enough of glfw for ``run_interactive``: a scripted queue of
    events delivered by ``wait_events_timeout``, one per call."""

    PRESS, RELEASE = 1, 0
    MOUSE_BUTTON_LEFT, MOUSE_BUTTON_RIGHT = 0, 1
    KEY_ESCAPE, KEY_ENTER, KEY_KP_ENTER = 256, 257, 335

    def __init__(self, events):
        super().__init__("glfw")
        self.events = list(events)
        self.cursor = (0.0, 0.0)
        self.closed = False
        self.terminated = False

    def init(self):
        return True

    def create_window(self, w, h, title, monitor, share):
        self.size, self.title = (w, h), title
        return "window"

    def make_context_current(self, win):
        pass

    def set_mouse_button_callback(self, win, cb):
        self.mouse = cb

    def set_key_callback(self, win, cb):
        self.key = cb

    def window_should_close(self, win):
        return self.closed

    def get_cursor_pos(self, win):
        return self.cursor

    def swap_buffers(self, win):
        pass

    def wait_events_timeout(self, t):
        if not self.events:
            self.closed = True
            return
        kind, *args = self.events.pop(0)
        if kind == "mouse":
            button, x, y = args
            self.cursor = (x, y)
            self.mouse("window", button, self.PRESS, 0)
            self.mouse("window", button, self.RELEASE, 0)
        elif kind == "key":
            self.key("window", args[0], 0, self.PRESS, 0)
        elif kind == "close":
            self.closed = True

    def destroy_window(self, win):
        self.destroyed = True

    def terminate(self):
        self.terminated = True


class _StubGL(types.ModuleType):
    GL_COLOR_BUFFER_BIT = GL_RGB = GL_UNSIGNED_BYTE = GL_UNPACK_ALIGNMENT = 0

    def __init__(self):
        super().__init__("OpenGL.GL")
        self.drawn = []

    def glDrawPixels(self, w, h, fmt, kind, data):
        self.drawn.append(np.array(data))

    def __getattr__(self, name):  # the other calls do nothing
        return lambda *a, **k: None


def _run_stubbed(monkeypatch, events, frame):
    glfw, gl = _StubGlfw(events), _StubGL()
    opengl = types.ModuleType("OpenGL")
    opengl.GL = gl
    monkeypatch.setitem(sys.modules, "glfw", glfw)
    monkeypatch.setitem(sys.modules, "OpenGL", opengl)
    monkeypatch.setitem(sys.modules, "OpenGL.GL", gl)
    out = tmc.run_interactive(frame, (8, 6), window="pick", device="cpu")
    return out, glfw, gl


def _board():
    frame = tpc.render_board(tpc.K_TRUE, np.zeros(5), *tpc._poses()[0])
    from vbr_tpu_torch.ops import camera as cam_ops

    cols, rows = tpc.PATTERN
    s = tpc.SQUARE
    outer = np.array([[-s, -s, 0], [cols * s, -s, 0],
                      [cols * s, rows * s, 0], [-s, rows * s, 0]], float)
    quad = cam_ops.project_points(outer, *tpc._poses()[0], tpc.K_TRUE,
                                  np.zeros(5))
    return frame, [(float(x), float(y)) for x, y in np.round(quad)]


def test_run_interactive_clicks_undo_and_enter(monkeypatch):
    """Enter before the fourth click does nothing; left clicks add, a
    right click undoes, Enter accepts: the result is the session's on the
    same integer clicks, and each frame shown is the overlay (RGB, rows
    from the top)."""
    frame, quad = _board()
    L, R = _StubGlfw.MOUSE_BUTTON_LEFT, _StubGlfw.MOUSE_BUTTON_RIGHT
    events = ([("key", _StubGlfw.KEY_ENTER)]
              + [("mouse", L, x + 0.6, y + 0.2) for x, y in quad[:3]]
              + [("mouse", L, 5.0, 5.0), ("mouse", R, 0.0, 0.0),
                 ("mouse", L, quad[3][0] + 0.6, quad[3][1] + 0.2),
                 ("key", _StubGlfw.KEY_KP_ENTER)])
    out, glfw, gl = _run_stubbed(monkeypatch, events, frame)
    want = tmc.ManualCornerSession(
        cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY), (8, 6), device="cpu")
    for x, y in quad:
        want.click(int(x + 0.6), int(y + 0.2))
    np.testing.assert_allclose(out, want.result, atol=1e-3)
    assert glfw.size == (frame.shape[1], frame.shape[0])
    assert glfw.title == "pick" and glfw.terminated
    assert gl.drawn[0].shape == frame.shape
    np.testing.assert_array_equal(gl.drawn[0], frame[..., ::-1])
    np.testing.assert_array_equal(
        gl.drawn[-1], tmc._overlay(frame, want.clicks, out)[..., ::-1])


@pytest.mark.parametrize("how", ["escape", "close"])
def test_run_interactive_aborts(monkeypatch, how):
    """Esc (or closing the window), even with the lattice shown, returns
    None."""
    frame, quad = _board()
    events = [("mouse", _StubGlfw.MOUSE_BUTTON_LEFT, x, y) for x, y in quad]
    events.append(("key", _StubGlfw.KEY_ESCAPE) if how == "escape"
                  else ("close",))
    out, glfw, _ = _run_stubbed(monkeypatch, events, frame)
    assert out is None and glfw.terminated


def test_run_interactive_without_glfw_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "glfw", None)
    with pytest.raises(ImportError, match="glfw"):
        tmc.run_interactive(np.zeros((8, 8, 3), np.uint8), device="cpu")
