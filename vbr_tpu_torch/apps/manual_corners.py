"""Interactive manual corner selection + interpolation fallback.

The port's counterpart of ``vbr_tpu/apps/manual_corners.py``: the
reference's recovery path when chessboard auto-detection fails
(camera_calibration.py:38-133,299-393).  The user clicks the 4 outer board
corners, the full inner lattice is interpolated through the 4-point
homography (host f64), sub-pixel refined (``corners.corner_subpix`` on
``device``), and shown for acceptance.

The interaction layer is separable for testing: ``ManualCornerSession``
consumes click events from any source; ``run_interactive`` feeds it from a
glfw window drawn with PyOpenGL (the window layer of ``viewer/app.py``;
it needs a display, and both packages, which the module itself does not
import).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from vbr_tpu_torch.ops import corners as corner_ops
from vbr_tpu_torch.utils.device import resolve_device

CLICK_BGR = (0, 0, 255)  # a click: filled red circle of radius 4
CLICK_RADIUS = 4
LATTICE_BGR = (0, 255, 0)  # a lattice point: filled green circle of radius 2
LATTICE_RADIUS = 2


class ManualCornerSession:
    """State machine: collect 4 clicks → interpolate → accept/reject.

    Click semantics follow the reference's selection UI: left click adds a
    corner (max 4), right click removes the most recent
    (manual_corner_selection, camera_calibration.py:38-87).  The
    refinement runs on ``device`` (a card unless ``device="cpu"``);
    ``result`` is an (N, 2) numpy array.
    """

    def __init__(self, gray: np.ndarray, pattern_size: Tuple[int, int] = (8, 6),
                 corners_are_outer: bool = True, refine: bool = True,
                 device="cuda"):
        self.gray = gray
        self.pattern_size = pattern_size
        self.corners_are_outer = corners_are_outer
        self.refine = refine
        self.device = resolve_device(device)
        self.clicks: List[Tuple[float, float]] = []
        self.result: Optional[np.ndarray] = None

    def click(self, x: float, y: float):
        if len(self.clicks) < 4:
            self.clicks.append((float(x), float(y)))
        if len(self.clicks) == 4:
            self._interpolate()

    def undo(self):
        if self.clicks:
            self.clicks.pop()
            self.result = None

    def _interpolate(self):
        quad = np.asarray(self.clicks, dtype=np.float64)
        pts = corner_ops.interpolate_image_points_from_corners(
            quad, self.pattern_size, self.corners_are_outer)
        if self.refine:
            pts = corner_ops.corner_subpix(
                self.gray, pts, (5, 5), device=self.device).cpu().numpy()
        self.result = pts

    @property
    def done(self) -> bool:
        return self.result is not None


def _disc_spans(radius: int):
    """(dy, half-width) spans of OpenCV's filled 8-connected circle
    (``cv2.circle(..., thickness=-1)``: the midpoint walk of
    ``drawing.cpp::Circle`` with ``fill``), each row's widest."""
    spans = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for row, half in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            spans[row] = max(spans.get(row, -1), half)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return sorted(spans.items())


def _paint_disc(img: np.ndarray, cx: int, cy: int, radius: int, bgr):
    """Fill OpenCV's disc of ``radius`` at (cx, cy), clipped at the edges."""
    H, W = img.shape[:2]
    for dy, half in _disc_spans(radius):
        y = cy + dy
        x0, x1 = max(cx - half, 0), min(cx + half, W - 1)
        if 0 <= y < H and x0 <= x1:
            img[y, x0:x1 + 1] = bgr


def _overlay(frame_bgr: np.ndarray, clicks, result) -> np.ndarray:
    """The frame ``run_interactive`` shows: a copy of ``frame_bgr`` with a
    red disc (radius 4) at every click, then, once the lattice exists, a
    green disc (radius 2) at every lattice point, centred on
    ``(int(x), int(y))`` as ``vbr_tpu``'s ``cv2.circle`` calls are."""
    vis = frame_bgr.copy()
    for x, y in clicks:
        _paint_disc(vis, int(x), int(y), CLICK_RADIUS, CLICK_BGR)
    if result is not None:
        for x, y in result:
            _paint_disc(vis, int(x), int(y), LATTICE_RADIUS, LATTICE_BGR)
    return vis


def _gui_modules():
    """(glfw, OpenGL.GL), or ``ImportError`` naming what is missing."""
    try:
        import glfw
        from OpenGL import GL as gl
    except Exception as e:  # absent, or present and unloadable
        raise ImportError(
            "run_interactive needs glfw and PyOpenGL (the 'glfw' and "
            f"'OpenGL' packages) for its window: {e}") from e
    return glfw, gl


def run_interactive(
    frame_bgr: np.ndarray, pattern_size=(8, 6), window="select corners",
    device="cuda",
) -> Optional[np.ndarray]:
    """Click UI in a glfw window: 4 left-clicks select the outer corners;
    right click undoes; Enter accepts the interpolated lattice, Esc (or
    closing the window) aborts and returns None."""
    glfw, gl = _gui_modules()
    from vbr_tpu_torch.ops.color import bgr_to_gray_u8
    import torch

    frame_bgr = np.ascontiguousarray(frame_bgr)
    gray = bgr_to_gray_u8(torch.from_numpy(frame_bgr)).numpy()
    session = ManualCornerSession(gray, pattern_size, device=device)
    H, W = frame_bgr.shape[:2]
    state = {"answer": None, "closed": False}

    def on_mouse(win, button, action, mods):
        if action != glfw.PRESS:
            return
        x, y = glfw.get_cursor_pos(win)
        if button == glfw.MOUSE_BUTTON_LEFT:
            session.click(int(x), int(y))  # cv2 reports integer pixels
        elif button == glfw.MOUSE_BUTTON_RIGHT:
            session.undo()

    def on_key(win, key, scancode, action, mods):
        if action != glfw.PRESS:
            return
        if key == glfw.KEY_ESCAPE:
            state["closed"] = True
        elif key in (glfw.KEY_ENTER, glfw.KEY_KP_ENTER) and session.done:
            state["answer"] = session.result
            state["closed"] = True

    if not glfw.init():
        raise RuntimeError("glfw.init failed (no display?)")
    win = glfw.create_window(W, H, window, None, None)
    if not win:
        glfw.terminate()
        raise RuntimeError("window creation failed")
    try:
        glfw.make_context_current(win)
        glfw.set_mouse_button_callback(win, on_mouse)
        glfw.set_key_callback(win, on_key)
        while not (state["closed"] or glfw.window_should_close(win)):
            rgb = _overlay(frame_bgr, session.clicks, session.result)[..., ::-1]
            gl.glClear(gl.GL_COLOR_BUFFER_BIT)
            gl.glRasterPos2f(-1.0, 1.0)  # top-left, rows drawn downward
            gl.glPixelZoom(1.0, -1.0)
            gl.glPixelStorei(gl.GL_UNPACK_ALIGNMENT, 1)
            gl.glDrawPixels(W, H, gl.GL_RGB, gl.GL_UNSIGNED_BYTE,
                            np.ascontiguousarray(rgb))
            glfw.swap_buffers(win)
            glfw.wait_events_timeout(0.03)  # cv2.waitKey(30)'s pace
    finally:
        glfw.destroy_window(win)
        glfw.terminate()
    return state["answer"]
