"""The port's GL engine against ``vbr_tpu``'s through a real GL context
(EGL surfaceless, Mesa's software rasterizer): each scene of
``tests/test_gl_offscreen.py`` is drawn by both packages' engines in turn,
and the images read back are bit-equal.  Skipped where EGL is missing."""

import json
import os
import types

import numpy as np
import pytest
import torch


def _egl_available():
    try:
        from vbr_tpu_torch.viewer.offscreen import OffscreenContext

        with OffscreenContext(64, 64):
            return True
    except Exception:
        return False


pytestmark = pytest.mark.skipif(
    not _egl_available(), reason="no EGL surfaceless support"
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG_XML = os.path.join(ROOT, "artifacts", "auto_extrinsics")


def _port():
    from vbr_tpu_torch.ops import marching_cubes
    from vbr_tpu_torch.pipelines import reconstruction
    from vbr_tpu_torch.utils import config
    from vbr_tpu_torch.viewer import gl_engine, offscreen, scene

    def extract_mesh(vol, **kw):
        return marching_cubes.extract_mesh(vol, device="cpu", **kw)

    return types.SimpleNamespace(
        eng=gl_engine, Offscreen=offscreen.OffscreenContext, scene=scene,
        rec=reconstruction, config=config, extract_mesh=extract_mesh)


def _reference():
    from vbr_tpu.ops import marching_cubes
    from vbr_tpu.pipelines import reconstruction
    from vbr_tpu.utils import config
    from vbr_tpu.viewer import gl_engine, offscreen, scene

    return types.SimpleNamespace(
        eng=gl_engine, Offscreen=offscreen.OffscreenContext, scene=scene,
        rec=reconstruction, config=config,
        extract_mesh=marching_cubes.extract_mesh)


def _view_proj(prog, vp):
    from OpenGL import GL as gl

    gl.glUseProgram(prog)
    gl.glUniformMatrix4fv(gl.glGetUniformLocation(prog, "u_view_proj"), 1,
                          True, vp.astype(np.float32))


def instanced_cubes_hdr(pkg, tmp_path, samples=0, n=200, seed=0):
    from OpenGL import GL as gl

    eng = pkg.eng
    W, H = 320, 240
    with pkg.Offscreen(W, H) as ctx:
        gl.glEnable(gl.GL_DEPTH_TEST)
        prog = eng.compile_program(eng.VERT_SRC, eng.FRAG_SRC)
        cubes = eng.InstancedCubes(max_instances=1000)
        hdr = eng.HDRPipeline(W, H, blur_passes=2, samples=samples)
        cam = eng.FlyCamera(position=(0, 0, 10), pitch=0, yaw=-90)
        rng = np.random.default_rng(seed)
        cubes.set_instances(rng.uniform(-3, 3, (n, 3)).astype(np.float32),
                            rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32))
        hdr.bind_scene()
        gl.glClearColor(0.0, 0.0, 0.0, 1.0)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)
        _view_proj(prog, eng.perspective(45.0, W / H, 0.1, 100.0)
                   @ cam.view_matrix())
        gl.glUniform1f(gl.glGetUniformLocation(prog, "u_scale"), 0.5)
        cubes.draw()
        hdr.resolve(target_fbo=ctx._fbo)
        return [ctx.read_pixels(), np.array([hdr.samples])]


def msaa_resolve(pkg, tmp_path):
    return (instanced_cubes_hdr(pkg, tmp_path, 0, n=40, seed=1)
            + instanced_cubes_hdr(pkg, tmp_path, 4, n=40, seed=1))


def custom_geometry(pkg, tmp_path):
    from OpenGL import GL as gl

    eng = pkg.eng
    with pkg.Offscreen(64, 64) as ctx:
        tri = np.array([[[-1, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
        m = eng.InstancedCubes(max_instances=4, geometry=tri)
        m.set_instances(np.array([[0, 0, 0], [0.3, -0.6, 0.1]], np.float32),
                        np.array([[1, 1, 1], [0.2, 0.5, 0.9]], np.float32))
        prog = eng.compile_program(eng.VERT_SRC, eng.FRAG_SRC)
        ctx.bind_default()
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)
        _view_proj(prog, np.eye(4, dtype=np.float32))
        gl.glUniform1f(gl.glGetUniformLocation(prog, "u_scale"), 1.0)
        m.draw()
        return [ctx.read_pixels(), np.array([m.n_verts, m.count])]


def textured_mesh(pkg, tmp_path):
    from OpenGL import GL as gl

    eng = pkg.eng
    W, H = 320, 240
    with pkg.Offscreen(W, H) as ctx:
        gl.glEnable(gl.GL_DEPTH_TEST)
        hdr = eng.HDRPipeline(W, H, blur_passes=2)
        tex_img = np.zeros((128, 128, 4), np.uint8)
        tex_img[..., 3] = 255
        tex_img[:64, :64, 0] = tex_img[64:, 64:, 0] = 255
        tex_img[:64, 64:, 1] = tex_img[64:, :64, 1] = 255
        tex = eng.Texture2D(tex_img)
        quad, uv = pkg.scene.floor_textured_tris(16, 16)
        mesh = eng.TexturedMesh()
        mesh.set_triangles(quad, uv / 8.0)
        cam = eng.FlyCamera(position=(0, 14, 0), pitch=-89.9, yaw=-90)
        vp = eng.perspective(60.0, W / H, 0.1, 100.0) @ cam.view_matrix()
        hdr.bind_scene()
        gl.glClearColor(0.0, 0.0, 0.0, 1.0)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)
        mesh.draw(vp, tex)
        hdr.resolve(target_fbo=ctx._fbo)
        return [ctx.read_pixels()]


def shadow_pipeline(pkg, tmp_path):
    from OpenGL import GL as gl

    eng = pkg.eng
    with pkg.Offscreen(64, 64):
        gl.glEnable(gl.GL_DEPTH_TEST)
        shadow = eng.ShadowPipeline(size=256)
        shadow.bind()
        cubes = eng.InstancedCubes(max_instances=10)
        rng = np.random.default_rng(4)
        cubes.set_instances(rng.uniform(-20, 20, (6, 3)).astype(np.float32),
                            np.ones((6, 3), np.float32))
        gl.glUniform1f(gl.glGetUniformLocation(shadow.prog, "u_scale"), 8.0)
        cubes.draw()
        shadow.unbind((64, 64))
        gl.glBindTexture(gl.GL_TEXTURE_2D, shadow.depth_tex)
        depth = gl.glGetTexImage(gl.GL_TEXTURE_2D, 0, gl.GL_DEPTH_COMPONENT,
                                 gl.GL_FLOAT)
        return [np.asarray(depth, np.float32), shadow.light_space]


def _write_camera_prop(res):
    """A small camera prop: a box body and a lens pyramid, two meshes
    under a transformed node."""
    os.makedirs(res, exist_ok=True)
    body = np.array([[x, y, z] for x in (-1, 1) for y in (-0.6, 0.6)
                     for z in (-0.8, 0.8)], float)
    faces = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
             [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    lens = np.array([[0, 0, 0.8], [-0.5, -0.4, 1.6], [0.5, -0.4, 1.6],
                     [0.5, 0.4, 1.6], [-0.5, 0.4, 1.6]])
    doc = {"rootnode": {"transformation": [0.5, 0, 0, 0, 0, 0.5, 0, 0, 0, 0,
                                           0.5, 0, 0, 0, 0, 1],
                        "meshes": [0, 1]},
           "meshes": [{"vertices": body.reshape(-1).tolist(),
                       "faces": faces},
                      {"vertices": lens.reshape(-1).tolist(),
                       "faces": [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1]]}]}
    with open(os.path.join(res, "camera.json"), "w") as f:
        json.dump(doc, f)


def scene_parity(pkg, tmp_path):
    """Camera props at the rig's poses, frustum wireframes and a
    marching-cubes surface through ``StaticMesh``."""
    from OpenGL import GL as gl

    eng, scene = pkg.eng, pkg.scene
    cams = [pkg.config.CameraParams.from_arrays(*a)
            for a in _load_rig_arrays()]
    res = str(tmp_path / "models")
    _write_camera_prop(res)
    W, H = 320, 240
    with pkg.Offscreen(W, H) as ctx:
        gl.glEnable(gl.GL_DEPTH_TEST)
        prog = eng.compile_program(eng.VERT_SRC, eng.FRAG_SRC)
        hdr = eng.HDRPipeline(W, H, blur_passes=2)
        cam = eng.FlyCamera(position=(0, 15, 30), pitch=-25, yaw=-90)
        cam_pos, cam_col = pkg.rec.get_cam_positions(cams)
        cam_meshes = []
        for tris, pos, col in zip(
            scene.camera_model_tris(cams, res, 2.0),
            np.asarray(cam_pos, np.float32), np.asarray(cam_col, np.float32),
        ):
            m = eng.InstancedCubes(max_instances=1, geometry=tris)
            m.set_instances(pos[None], col[None])
            cam_meshes.append(m)
        frusta = eng.Lines()
        frusta.set_segments(scene.rig_frustum_segments(cams))
        surface = eng.StaticMesh()
        vol = np.zeros((16, 16, 16), bool)
        vol[4:12, 4:12, 4:12] = True
        vol[6:10, 10:14, 6:10] = True
        tris_mm, _ = pkg.extract_mesh(vol, origin=(-512, -1024, -2048),
                                      spacing=(96, 128, 160))
        surface.set_triangles(scene.surface_tris_to_viewer(tris_mm))
        hdr.bind_scene()
        gl.glClearColor(0.0, 0.0, 0.0, 1.0)
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)
        vp = eng.perspective(45.0, W / H, 0.1, 500.0) @ cam.view_matrix()
        _view_proj(prog, vp)
        gl.glUniform1f(gl.glGetUniformLocation(prog, "u_scale"), 1.0)
        for m in cam_meshes:
            m.draw()
        surface.draw(vp)
        frusta.draw(vp)
        hdr.resolve(target_fbo=ctx._fbo)
        return [ctx.read_pixels(), np.array([surface.count])]


def texture_file(pkg, tmp_path):
    """``load_texture_file`` of a PNG in a live context: the texture's
    level 0 as GL holds it."""
    from OpenGL import GL as gl
    from PIL import Image

    png = str(tmp_path / "t.png")
    if not os.path.exists(png):
        img = np.random.default_rng(6).integers(0, 256, (24, 40, 3),
                                                np.uint8)
        Image.fromarray(img).save(png)
    with pkg.Offscreen(32, 32):
        t = pkg.eng.load_texture_file(png)
        gl.glBindTexture(gl.GL_TEXTURE_2D, t.tex)
        texels = gl.glGetTexImage(gl.GL_TEXTURE_2D, 0, gl.GL_RGBA,
                                  gl.GL_UNSIGNED_BYTE)
        t.delete()
        assert t.tex == 0
        return [np.frombuffer(texels, np.uint8).reshape(24, 40, 4)]


def _load_rig_arrays():
    from vbr_tpu_torch.utils import xmlio

    return [xmlio.load_camera_config(RIG_XML, f"cam{i}_config.xml")
            for i in range(1, 5)]


SCENES = {"instanced cubes, HDR chain": instanced_cubes_hdr,
          "MSAA resolve": msaa_resolve,
          "custom geometry": custom_geometry,
          "textured mesh": textured_mesh,
          "shadow pipeline": shadow_pipeline,
          "camera props, frusta, surface": scene_parity,
          "texture file": texture_file}


@pytest.mark.parametrize("name", list(SCENES))
def test_engines_draw_the_same_pixels(tmp_path, name):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = SCENES[name](_reference(), tmp_path)
        got = SCENES[name](_port(), tmp_path)
    finally:
        torch.set_num_threads(n)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert np.asarray(got[0], np.float64).std() > 0, "an empty image"
