"""Interactive voxel-hull viewer (GLFW + GL 3.3 core).

The port's counterpart of ``vbr_tpu/viewer/app.py``, the
``executable.py`` equivalent: window + render loop + input handling; ``G``
advances to the next video frame and re-carves (the reference's
re-voxelize key, executable.py:185-188), ``M`` toggles the voxel cloud ↔
marching-cubes surface display, ``F`` toggles frustum wireframes,
WASD/mouse fly the camera.

Scene parity with the reference (executable.py:110-127): the assimp-JSON
camera model is drawn at each camera pose with its viewer rotation matrix,
the floor checkerboard uses the square prop, and voxels use the cube prop
(built-in geometry fallbacks when the model files are absent).

Consumes ONLY the reconstruction pipeline's public contract — positions +
colors arrays — exactly like the reference viewer's 4-function seam
(executable.py:9).  As in ``vbr_tpu``, the frames come from the rig's
``cam*/video.avi`` (``utils.video.MultiCameraSource``) and the background
models are trained on its ``background.avi``; ``source=``, ``cache_dir=``
and ``background_frames=`` replace either.  What
``G`` and ``M`` compute, ``recarve`` and ``rebuild_surface``, are module
functions over a ``ViewerState``, so they run without a window.  The floor
spans ``world_width × world_depth`` (``vbr_tpu`` passes the width twice).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from vbr_tpu_torch.ops import carve as carve_ops
from vbr_tpu_torch.ops import marching_cubes as mc
from vbr_tpu_torch.pipelines import reconstruction
from vbr_tpu_torch.pipelines.background import BackgroundPipeline
from vbr_tpu_torch.utils.config import AppConfig, GridConfig, RigConfig
from vbr_tpu_torch.viewer import scene


@dataclasses.dataclass
class ViewerState:
    """What the viewer's keys act on: the frame source, the mask stage,
    the carve (whose ``grid`` and ``rig`` it uses), the display toggles and
    the last carved occupancy volume (on the carve's device)."""

    source: Any  # utils.video.FrameSource
    background: BackgroundPipeline
    recon: reconstruction.Reconstructor
    show_mesh: bool = False
    show_frusta: bool = True
    occ_vol: Optional[Any] = None  # (nx, ny, nz) bool tensor
    last_x: Optional[float] = None
    last_y: Optional[float] = None


def recarve(state: ViewerState):
    """Take the source's next frames, mask and carve them: (positions
    (M, 3) f32, colors (M, 3) f32) numpy in the viewer contract, or None at
    the end of the stream.  Keeps the occupancy volume for
    ``rebuild_surface``."""
    frames = state.source.next_frames()
    if frames is None:
        return None
    recon = state.recon
    masks = state.background.masks_for_frames(frames)
    occ, col = recon.carve_frame(masks, frames)
    pos, rgb = carve_ops.compact_voxels(occ, col, recon.grid,
                                        recon.rig.scaling_factor)
    state.occ_vol = occ.reshape(recon.grid.shape)
    return pos, rgb


def rebuild_surface(state: ViewerState):
    """Marching-cubes surface of the last carve as (T, 3, 3) f32 viewer
    triangles, or None before the first carve."""
    vol = state.occ_vol
    if vol is None:
        return None
    grid = state.recon.grid
    xs, ys, zs = grid.axis_ranges()
    tris_mm, _ = mc.extract_mesh(
        vol,
        origin=(xs[0], ys[0], zs[0]),
        spacing=(xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]),
    )
    return scene.surface_tris_to_viewer(tris_mm,
                                        state.recon.rig.scaling_factor)


def run_viewer(data_dir: str, config: AppConfig = AppConfig(),
               resources_dir: str | None = None, *, source=None,
               cache_dir: str | None = None, background_frames=None,
               device="cuda"):
    """Open the window on the rig of ``data_dir`` (``cam{i}/config.xml``)
    and show the frames of ``source`` (default: the rig's
    ``cam{i}/video.avi``); the background models come from ``cache_dir``
    (``mog_cam{i}.npz``), ``background_frames`` or the rig's
    ``background.avi`` (see ``BackgroundPipeline``).  Needs PyOpenGL and
    glfw."""
    from vbr_tpu_torch.utils.video import MultiCameraSource

    # pipeline state, made before the window: a missing video raises here
    grid = GridConfig(
        nx=config.world_width, ny=config.world_height * 2, nz=config.world_depth
    )
    rig = RigConfig()
    cams = reconstruction.load_rig(data_dir)
    state = ViewerState(
        source=MultiCameraSource(data_dir) if source is None else source,
        background=BackgroundPipeline(
            data_dir, cache_dir=cache_dir,
            background_frames=background_frames, device=device),
        recon=reconstruction.Reconstructor(cams, grid, rig, device=device),
    )

    import glfw
    from OpenGL import GL as gl

    from vbr_tpu_torch.viewer import gl_engine as eng

    if not glfw.init():
        raise RuntimeError("glfw.init failed (no display?)")
    glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
    glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
    glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
    glfw.window_hint(glfw.SAMPLES, config.sampling_level)
    window = glfw.create_window(
        config.window_width, config.window_height, "vbr_tpu viewer", None, None
    )
    if not window:
        glfw.terminate()
        raise RuntimeError("window creation failed")
    glfw.make_context_current(window)

    gl.glEnable(gl.GL_DEPTH_TEST)
    gl.glEnable(gl.GL_CULL_FACE)

    if resources_dir is None:
        resources_dir = scene.default_resources_dir(data_dir)

    prog = eng.compile_program(eng.VERT_SRC, eng.FRAG_SRC)
    cube_tris = scene.load_prop_tris(resources_dir, "cube")
    square_tris = scene.load_prop_tris(resources_dir, "square")
    cubes = eng.InstancedCubes(geometry=cube_tris)
    floor = eng.InstancedCubes(
        max_instances=config.world_width * config.world_depth,
        geometry=square_tris,
    )
    hdr = eng.HDRPipeline(config.window_width, config.window_height,
                          samples=config.sampling_level)
    camera = eng.FlyCamera()
    surface = eng.StaticMesh()
    frusta = eng.Lines()

    floor_pos, floor_col, cam_pos, cam_col = scene.floor_and_cam_instances(
        cams, config.world_width, config.world_depth
    )
    floor.set_instances(floor_pos, floor_col)

    # Textured floor when the reference's grid texture is present
    # (executable.py:114): one mipmapped quad replaces the instanced
    # black/white squares.  Falls back to the flat-color instances.
    floor_tex = eng.load_texture_file(
        scene.prop_texture_path(resources_dir, grid=True)
    )
    floor_textured = None
    if floor_tex is not None:
        floor_textured = eng.TexturedMesh()
        floor_textured.set_triangles(
            *scene.floor_textured_tris(config.world_width,
                                       config.world_depth)
        )

    # each camera: its own rotated prop model, one instance at its center
    # (executable.py:110,125-127)
    cam_meshes = []
    for tris, pos, col in zip(
        scene.camera_model_tris(cams, resources_dir), cam_pos, cam_col
    ):
        m = eng.InstancedCubes(max_instances=1, geometry=tris)
        m.set_instances(pos[None], col[None])
        cam_meshes.append(m)
    frusta.set_segments(
        scene.rig_frustum_segments(
            cams, (rig.image_height, rig.image_width)
        )
    )

    def show_surface():
        tris = rebuild_surface(state)
        if tris is not None:
            surface.set_triangles(tris)

    def show_next_frame():
        out = recarve(state)
        if out is None:
            return
        cubes.set_instances(*out)
        if state.show_mesh:
            show_surface()

    def key_cb(win, key, scancode, action, mods):
        if action != glfw.PRESS:
            return
        if key == glfw.KEY_ESCAPE:
            glfw.set_window_should_close(win, True)
        if key == glfw.KEY_G:
            show_next_frame()
        if key == glfw.KEY_M:
            state.show_mesh = not state.show_mesh
            if state.show_mesh and surface.count == 0:
                show_surface()
        if key == glfw.KEY_F:
            state.show_frusta = not state.show_frusta

    def mouse_cb(win, x, y):
        if state.last_x is not None:
            camera.rotate((x - state.last_x) * 0.2,
                          -(y - state.last_y) * 0.2)
        state.last_x, state.last_y = x, y

    glfw.set_key_callback(window, key_cb)
    glfw.set_cursor_pos_callback(window, mouse_cb)

    proj = eng.perspective(
        45.0, config.window_width / config.window_height, config.near, config.far
    )

    while not glfw.window_should_close(window):
        speed = 0.4
        if glfw.get_key(window, glfw.KEY_W) == glfw.PRESS:
            camera.move(forward=1, speed=speed)
        if glfw.get_key(window, glfw.KEY_S) == glfw.PRESS:
            camera.move(forward=-1, speed=speed)
        if glfw.get_key(window, glfw.KEY_A) == glfw.PRESS:
            camera.move(right=-1, speed=speed)
        if glfw.get_key(window, glfw.KEY_D) == glfw.PRESS:
            camera.move(right=1, speed=speed)

        hdr.bind_scene()
        gl.glClearColor(0.05, 0.05, 0.07, 1.0)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)

        vp = (proj @ camera.view_matrix()).astype(np.float32)
        gl.glUseProgram(prog)
        gl.glUniformMatrix4fv(
            gl.glGetUniformLocation(prog, "u_view_proj"), 1, True, vp
        )
        draws = ([] if floor_textured else [(floor, 1.0)]) \
            + [(m, 1.0) for m in cam_meshes]
        if not state.show_mesh:
            draws.append((cubes, 1.0))
        for mesh, scale in draws:
            gl.glUniform1f(gl.glGetUniformLocation(prog, "u_scale"), scale)
            mesh.draw()
        if floor_textured:
            floor_textured.draw(vp, floor_tex)
        if state.show_mesh:
            surface.draw(vp)
        if state.show_frusta:
            frusta.draw(vp)

        hdr.resolve()
        glfw.swap_buffers(window)
        glfw.poll_events()

    glfw.terminate()
