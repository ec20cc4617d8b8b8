"""The port's viewer (``vbr_tpu_torch/viewer``) against ``vbr_tpu``'s on
the CPU: ``models3d`` and ``scene`` exactly, the GL engine's GL-free part
and texture decoding, the headless splat renderer, ``save_png``, and
``app``'s carve, surface and floor, on the rig of
``artifacts/auto_extrinsics`` (the ``data_dir`` fixtures skip here).

The renderer is bit-equal to ``vbr_tpu``'s on clouds whose projections
are generic.  On lattices the two can differ at a few pixels, and only
where a splat's f64 pixel coordinate lies on an integer in exact
arithmetic (numpy's BLAS matmul and the port's elementwise projection
round it to either side; with the default eye, every point with x = z
lands on the image's centre column) or where splats of equal depth meet
(the port's sort is stable, numpy's is not): the tests check that every
differing pixel is one of those and bound their share of the covered
pixels at what they measure, rounded up."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

# PyOpenGL picks its platform when it is first imported, and vbr_tpu's
# gl_engine imports it with the module: pick EGL, as the offscreen context
# does, so that a GL test run later in this process gets its context.
for _key, _value in (("EGL_PLATFORM", "surfaceless"),
                     ("PYOPENGL_PLATFORM", "egl"),
                     ("LIBGL_ALWAYS_SOFTWARE", "1")):
    os.environ.setdefault(_key, _value)

from vbr_tpu.ops import carve as jcarve  # noqa: E402
from vbr_tpu.ops import marching_cubes as jmc
from vbr_tpu.pipelines import background as jbackground
from vbr_tpu.pipelines import reconstruction as jrec
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import video as jvideo
from vbr_tpu.viewer import app as japp
from vbr_tpu.viewer import gl_engine as jeng
from vbr_tpu.viewer import headless as jh
from vbr_tpu.viewer import models3d as jm
from vbr_tpu.viewer import scene as jscene
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops.gmm import MOGState
from vbr_tpu_torch.pipelines import reconstruction as trec
from vbr_tpu_torch.pipelines.background import BackgroundPipeline
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import synthetic as tsyn
from vbr_tpu_torch.utils import xmlio as txml
from vbr_tpu_torch.utils.video import ArraySource
from vbr_tpu_torch.viewer import app as tapp
from vbr_tpu_torch.viewer import gl_engine as teng
from vbr_tpu_torch.viewer import headless as th
from vbr_tpu_torch.viewer import models3d as tm
from vbr_tpu_torch.viewer import scene as tscene


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
RIG_MASKS = os.path.join(ROOT, "artifacts", "final", "mask_cam{}.png")
BACKGROUND = (0.08, 0.08, 0.1)  # render_points' default
ORBIT_TARGET = (4.0, 6.0, 0.0)


def orbit_eye(theta_deg, radius=38.0, height=24.0, target=ORBIT_TARGET):
    """The eye of ``vbr_tpu/apps/cli.py``'s ``orbit_pose``."""
    th_ = np.radians(theta_deg)
    return (target[0] + radius * np.cos(th_), height,
            target[2] + radius * np.sin(th_))


VIEWS = {"default": ((25.0, 20.0, 25.0), (0.0, 5.0, 0.0)),
         "orbit -135": (orbit_eye(-135.0), ORBIT_TARGET),
         "orbit 45": (orbit_eye(45.0), ORBIT_TARGET)}


@pytest.fixture(scope="module")
def rig():
    """The rig's cameras in each package: (port's, vbr_tpu's)."""
    arrays = [txml.load_camera_config(RIG_XML, f"cam{i}_config.xml")
              for i in range(1, 5)]
    return ([tconfig.CameraParams.from_arrays(*a) for a in arrays],
            [jconfig.CameraParams.from_arrays(*a) for a in arrays])


def assert_same(a, b):
    """Equal values, shapes and dtypes (None for None)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- models3d -------------------------------------------------------------


def _rotation(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    th_ = np.radians(deg)
    return np.eye(3) + np.sin(th_) * K + (1 - np.cos(th_)) * K @ K


def _transform(axis, deg, scale, shift):
    m = np.eye(4)
    m[:3, :3] = _rotation(axis, deg) * scale
    m[:3, 3] = shift
    return m.reshape(-1).tolist()


def _mesh(rng, n_verts, n_faces, uv_stride=None, normals=True):
    m = {"vertices": rng.normal(0, 3, 3 * n_verts).tolist(),
         "faces": rng.integers(0, n_verts, (n_faces, 3)).tolist()}
    if normals:
        m["normals"] = rng.normal(0, 1, 3 * n_verts).tolist()
    if uv_stride:
        m["texturecoords"] = [rng.uniform(0, 1, uv_stride * n_verts).tolist()]
    return m


def _model_doc(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "hierarchy":  # three meshes, two transformed, one not
        return {"rootnode": {
            "transformation": _transform((1, 2, 3), 31.0, 1.5, (5, -2, 7)),
            "meshes": [0],
            "children": [{
                "transformation": _transform((0, 1, 0), -73.0, 0.25,
                                             (0.1, 0.2, 0.3)),
                "meshes": [1]}]},
            "meshes": [_mesh(rng, 7, 5, uv_stride=2),
                       _mesh(rng, 6, 4, uv_stride=3),
                       _mesh(rng, 4, 2, uv_stride=None, normals=False)]}
    if kind == "no uvs, no rootnode":
        return {"meshes": [_mesh(rng, 5, 3, uv_stride=None)]}
    if kind == "identity node, stride 3":
        return {"rootnode": {"meshes": [0]},
                "meshes": [_mesh(rng, 9, 6, uv_stride=3, normals=False)]}
    return {"meshes": []}


@pytest.mark.parametrize("apply_transforms", [True, False])
@pytest.mark.parametrize("kind", ["hierarchy", "no uvs, no rootnode",
                                  "identity node, stride 3", "empty"])
def test_models3d_matches_the_reference(tmp_path, kind, apply_transforms):
    path = str(tmp_path / "prop.json")
    with open(path, "w") as f:
        json.dump(_model_doc(kind), f)
    got = tm.load_assimp_json(path, apply_transforms)
    want = jm.load_assimp_json(path, apply_transforms)
    assert len(got) == len(want) == len(_model_doc(kind)["meshes"])
    for g, w in zip(got, want):
        for field in tm.MeshData._fields:
            assert_same(getattr(g, field), getattr(w, field))
    assert_same(tm.mesh_to_tris(got), jm.mesh_to_tris(want))
    for a, b in zip(tm.mesh_to_tris_uv(got), jm.mesh_to_tris_uv(want)):
        assert_same(a, b)
    if kind == "hierarchy" and apply_transforms:
        untouched = tm.load_assimp_json(path, False)
        assert not np.array_equal(got[1].vertices, untouched[1].vertices)
        assert_same(got[2].vertices, untouched[2].vertices)


# -- scene ----------------------------------------------------------------


@pytest.fixture(scope="module")
def props(tmp_path_factory):
    """A resources directory with camera, cube and square props, and an
    empty one (the built-in geometry fallbacks)."""
    d = tmp_path_factory.mktemp("resources") / "models"
    d.mkdir()
    for name in ("camera", "cube", "square"):
        with open(d / f"{name}.json", "w") as f:
            json.dump(_model_doc("hierarchy" if name == "camera"
                                 else "identity node, stride 3"), f)
    empty = tmp_path_factory.mktemp("no_resources")
    return str(d), str(empty)


@pytest.mark.parametrize("which", ["props", "fallback"])
def test_scene_props_match(rig, props, which):
    res = props[0] if which == "props" else props[1]
    tcams, jcams = rig
    for name in ("camera", "cube", "square", "missing"):
        assert_same(tscene.load_prop_tris(res, name),
                    jscene.load_prop_tris(res, name))
        got, want = (tscene.load_prop_textured(res, name),
                     jscene.load_prop_textured(res, name))
        assert (got is None) == (want is None) == (
            which == "fallback" or name == "missing")
        for a, b in zip(got or (), want or ()):
            assert_same(a, b)
    for scale in (1.0, 0.37):
        got = tscene.camera_model_tris(tcams, res, scale)
        want = jscene.camera_model_tris(jcams, res, scale)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert_same(a, b)
    assert_same(tscene.unit_cube_tris(), jscene.unit_cube_tris())
    assert tscene.prop_texture_path(res) == jscene.prop_texture_path(res)
    assert (tscene.prop_texture_path(res, "normal", grid=True)
            == jscene.prop_texture_path(res, "normal", grid=True))
    assert (tscene.default_resources_dir(res)
            == jscene.default_resources_dir(res))


@pytest.mark.parametrize("image_hw, depth_mm", [((486, 644), 700.0),
                                                ((240, 320), 1234.5)])
def test_scene_frusta_match(rig, image_hw, depth_mm):
    """Exact: the port's ``rodrigues`` is ``vbr_tpu``'s numpy branch."""
    tcams, jcams = rig
    for tc, jc in zip(tcams, jcams):
        assert_same(tscene.camera_frustum_segments(tc, image_hw, depth_mm,
                                                   100.0),
                    jscene.camera_frustum_segments(jc, image_hw, depth_mm,
                                                   100.0))
    assert_same(tscene.rig_frustum_segments(tcams, image_hw,
                                            depth_mm=depth_mm),
                jscene.rig_frustum_segments(jcams, image_hw,
                                            depth_mm=depth_mm))


@pytest.mark.parametrize("width, depth", [(8, 6), (5, 9), (128, 128)])
def test_scene_floor_and_cameras_match(rig, width, depth):
    tcams, jcams = rig
    got = tscene.floor_and_cam_instances(tcams, width, depth)
    want = jscene.floor_and_cam_instances(jcams, width, depth)
    for a, b in zip(got, want):
        assert_same(a, b)
    assert len(got[0]) == width * depth
    for a, b in zip(tscene.floor_textured_tris(width, depth),
                    jscene.floor_textured_tris(width, depth)):
        assert_same(a, b)


@pytest.mark.parametrize("scaling", [64.0, 1.0, 17.5])
def test_surface_tris_to_viewer_matches(scaling):
    tris = np.random.default_rng(3).normal(0, 900, (50, 3, 3))
    assert_same(tscene.surface_tris_to_viewer(tris, scaling),
                jscene.surface_tris_to_viewer(tris, scaling))
    assert_same(tscene.surface_tris_to_viewer(tris.astype(np.float32)),
                jscene.surface_tris_to_viewer(tris.astype(np.float32)))


# -- gl_engine: the GL-free part and texture decoding ----------------------


def test_gl_free_part_matches():
    assert_same(teng.CUBE_VERTS, jeng.CUBE_VERTS)
    assert (teng.EXPOSURE, teng.GAMMA) == (jeng.EXPOSURE, jeng.GAMMA)
    for name in ("VERT_SRC", "FRAG_SRC", "QUAD_VERT", "BLUR_FRAG",
                 "HDR_FRAG", "MESH_VERT", "MESH_FRAG", "TEX_MESH_VERT",
                 "TEX_MESH_FRAG", "LINE_VERT", "LINE_FRAG",
                 "SHADOW_DEPTH_VERT", "SHADOW_DEPTH_FRAG"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert_same(teng.perspective(45.0, 4 / 3, 0.1, 500.0),
                jeng.perspective(45.0, 4 / 3, 0.1, 500.0))
    assert_same(teng.ortho(-3, 5, -2, 7, 1.0, 200.0),
                jeng.ortho(-3, 5, -2, 7, 1.0, 200.0))
    assert_same(teng.look_at_gl((3, 4, 5), (0, 1, 0), (0, 1, 0)),
                jeng.look_at_gl((3, 4, 5), (0, 1, 0), (0, 1, 0)))
    tc, jc = teng.FlyCamera(), jeng.FlyCamera()
    for cam in (tc, jc):
        cam.rotate(33.0, 12.5)
        cam.move(forward=1, speed=0.4)
        cam.move(right=-1, speed=0.4)
        cam.rotate(-400.0, 200.0)  # pitch clamps at 89.9
    assert_same(tc.front, jc.front)
    assert_same(tc.position, jc.position)
    assert_same(tc.view_matrix(), jc.view_matrix())


def test_gl_classes_raise_import_error_without_pyopengl():
    """Without PyOpenGL the module imports and its GL-free part works; a GL
    class or ``compile_program`` raises ``ImportError`` naming PyOpenGL
    (``vbr_tpu`` raises ``NameError`` there)."""
    code = (
        "import sys\n"
        "sys.modules['OpenGL'] = None\n"
        "from vbr_tpu_torch.viewer import gl_engine as eng\n"
        "assert not eng.HAVE_GL and eng.FlyCamera().view_matrix().shape "
        "== (4, 4)\n"
        "calls = [lambda: eng.compile_program(eng.VERT_SRC, eng.FRAG_SRC),\n"
        "         lambda: eng.InstancedCubes(10), eng.StaticMesh,\n"
        "         eng.TexturedMesh, lambda: eng.Texture2D(None), eng.Lines,\n"
        "         lambda: eng.HDRPipeline(8, 8), eng.ShadowPipeline]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'PyOpenGL' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.fixture()
def texels(monkeypatch):
    """``load_texture_file`` of either package returning the RGBA array it
    would upload (no GL context needed)."""
    for eng in (teng, jeng):
        monkeypatch.setattr(eng, "Texture2D", lambda rgba: np.array(rgba))


def _image(mode, rng):
    from PIL import Image

    if mode == "P":
        return Image.fromarray(rng.integers(0, 256, (21, 34), np.uint8),
                               "L").convert("P", palette=Image.ADAPTIVE,
                                             colors=16)
    shape = {"L": (21, 34), "RGB": (21, 34, 3), "RGBA": (21, 34, 4)}[mode]
    img = rng.integers(0, 256, shape, np.uint8)
    img[:8] = 255 // 3  # flat rows, so the JPEG has smooth regions too
    return Image.fromarray(img, mode)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_load_texture_file_png_matches_cv2(tmp_path, texels, mode):
    """A PNG decodes to the same RGBA texels through PIL as ``vbr_tpu``'s
    cv2 path gives, bottom row first."""
    path = str(tmp_path / f"t_{mode}.png")
    _image(mode, np.random.default_rng(7)).save(path)
    got, want = teng.load_texture_file(path), jeng.load_texture_file(path)
    assert got.shape == (21, 34, 4) and got.dtype == np.uint8
    assert_same(got, want)


# measured 0 (PIL 12.1 and OpenCV 5.0 decode these JPEGs alike); two
# libjpeg builds may round the IDCT differently, and the bound would move
JPEG_TOLERANCE = 0


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_load_texture_file_jpeg_within_the_decoders_spread(tmp_path, texels,
                                                           mode):
    path = str(tmp_path / f"t_{mode}.jpg")
    _image(mode, np.random.default_rng(8)).save(path, quality=85)
    got, want = teng.load_texture_file(path), jeng.load_texture_file(path)
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"JPEG ({mode}) texels differ by at most {diff.max()}")
    assert got.shape == want.shape and diff.max() <= JPEG_TOLERANCE
    assert (got[..., 3] == 255).all()


def test_load_texture_file_missing_or_undecodable(tmp_path, texels):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image at all")
    for path in (str(tmp_path / "missing.jpg"), str(bad)):
        assert teng.load_texture_file(path) is None
        assert jeng.load_texture_file(path) is None


# -- headless: the splat renderer -----------------------------------------


def _tie_free_cloud(seed, n=2000, view="default", hw=(720, 960)):
    """Seeded uniform f32 points around the target, a tenth of them near
    and behind the eye, a tenth far off screen, and points placed on the
    image's border columns and rows (pixel coordinates in (-1, 0), the
    truncation to 0 that passes, and just past W - 1 and H - 1)."""
    rng = np.random.default_rng(seed)
    eye, target = VIEWS[view]
    pos = rng.uniform(-12, 12, (n, 3)) + np.asarray(target)
    pos[: n // 10] += np.asarray(eye) - np.asarray(target)
    pos[n // 10: n // 5] = rng.uniform(-300, 300, (n // 10, 3))
    H, W = hw
    R, t = jh.look_at(eye, target)
    f = 0.5 * W / np.tan(np.radians(50.0) / 2)
    k = 40
    z = rng.uniform(10, 60, 4 * k)
    u = np.concatenate([rng.uniform(-1, 0.5, k), rng.uniform(W - 1.5, W + 1, k),
                        rng.uniform(0, W, 2 * k)])
    v = np.concatenate([rng.uniform(0, H, 2 * k), rng.uniform(-1, 0.5, k),
                        rng.uniform(H - 1.5, H + 1, k)])
    cam = np.stack([(u - W / 2) * z / f, (v - H / 2) * z / f, z], -1)
    border = (cam - t) @ R  # back to the world: R.T @ (pc - t)
    pos = np.concatenate([pos, border]).astype(np.float32)
    col = rng.uniform(-0.1, 1.1, pos.shape).astype(np.float32)  # clipped
    return pos, col


@pytest.mark.parametrize("point_size", [1, 3])
@pytest.mark.parametrize("view", list(VIEWS))
def test_render_points_bit_equal_on_tie_free_clouds(view, point_size):
    eye, target = VIEWS[view]
    pos, col = _tie_free_cloud(len(view) + point_size, view=view)
    want = jh.render_points(pos, col, eye=eye, target=target,
                            point_size=point_size)
    got = th.render_points(pos, col, eye=eye, target=target,
                           point_size=point_size, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    covered = (want != np.uint8(np.float32(BACKGROUND) * 255)).any(-1)
    assert covered.sum() > 1000
    # the border columns and rows: truncation keeps (-1, 0) on screen
    for edge in (covered[:, 0], covered[:, -1], covered[0], covered[-1]):
        assert edge.sum() > 5


@pytest.mark.parametrize("hw, background", [((720, 960), BACKGROUND),
                                            ((37, 53), (0.5, 0.25, 1.0))])
def test_render_points_empty_and_small(hw, background):
    empty = np.zeros((0, 3), np.float32)
    got = th.render_points(empty, empty, image_hw=hw, background=background,
                           device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), jh.render_points(empty, empty, image_hw=hw,
                                      background=background))
    pos, col = _tie_free_cloud(4, n=300, hw=hw)
    got = th.render_points(torch.from_numpy(pos), col, image_hw=hw,
                           background=background, point_size=5)
    np.testing.assert_array_equal(
        got.numpy(), jh.render_points(pos, col, image_hw=hw,
                                      background=background, point_size=5))


def test_render_points_needs_a_card_for_numpy_input():
    """Numpy input goes to ``device`` (default the card), which raises
    without one; a CPU tensor runs where it lies."""
    pos, col = _tie_free_cloud(5, n=50)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        th.render_points(pos, col)
    with pytest.raises(RuntimeError, match="CUDA"):
        th.render_points(np.zeros((0, 3)), np.zeros((0, 3)))
    img = th.render_points(torch.from_numpy(pos), torch.from_numpy(col))
    assert img.device.type == "cpu" and img.shape == (720, 960, 3)


@pytest.mark.parametrize("view", list(VIEWS))
def test_floor_and_cameras_match(rig, view):
    """The CLI's scene: the splats, a 64 × 64 floor (f64 lists through
    ``np.asarray``, as ``cmd_render`` passes them; then the viewer's f32
    arrays) and the rig's cameras.  The floor is a lattice: its tiles may
    land one pixel apart where their pixel coordinate is an integer (the
    edge pixels); every other pixel is equal."""
    eye, target = VIEWS[view]
    tcams, jcams = rig
    pos, col = _tie_free_cloud(9, view=view)
    floor_pos, floor_col = jrec.generate_grid(64, 64)
    cam_pos, cam_col = jrec.get_cam_positions(jcams)
    args = (np.asarray(floor_pos), np.asarray(floor_col),
            np.asarray(cam_pos, float), cam_col)
    fp, fc, cp, cc = tscene.floor_and_cam_instances(tcams, 40, 24)
    n_differ = 0
    for args in (args, (fp, fc, cp, cc)):
        want = jh.render_points(pos, col, eye=eye, target=target)
        jh.render_floor_and_cameras(want, *args, eye=eye, target=target)
        got = th.render_points(pos, col, eye=eye, target=target,
                               device="cpu")
        # drawn in place on the render's tensor
        assert th.render_floor_and_cameras(got, *args, eye=eye,
                                           target=target) is got
        got = got.numpy()
        differ = (got != want).any(-1)
        excused = (edge_pixels(args[0], eye, target, (720, 960), 0)
                   | edge_pixels(args[2], eye, target, (720, 960), 3))
        assert not (differ & ~excused).any()
        assert (want == np.uint8(200)).all(-1).any()  # white tiles drawn
        n_differ += int(differ.sum())
    print(f"{view}: {n_differ} floor pixels differ, each at an edge pixel")


def _projection(pos, eye, target, hw, fov_deg=50.0):
    """The port's f64 pixel coordinates and depths of the points in front
    of the eye (its own projection, on the CPU)."""
    H, W = hw
    R, t = th.look_at(eye, target)
    x, y, z = (a.numpy() for a in th._camera_frame(
        torch.from_numpy(np.asarray(pos, np.float64)), R, t))
    ok = z > th.NEAR
    f = th._focal(W, fov_deg)
    return x[ok] * f / z[ok] + W / 2, y[ok] * f / z[ok] + H / 2, z[ok]


def _splat(mask, u, v, r):
    H, W = mask.shape
    keep = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v = u[keep].astype(np.int64), v[keep].astype(np.int64)
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            mask[np.clip(v + dv, 0, H - 1), np.clip(u + du, 0, W - 1)] = True


def edge_pixels(pos, eye, target, hw, r, tol=1e-9):
    """Pixels of the (2r+1)² splats, at either of their two truncations,
    of the points whose pixel coordinate is within ``tol`` of an integer:
    there the two projections may round to either side."""
    uf, vf, _ = _projection(pos, eye, target, hw)
    out = np.zeros(hw, bool)
    bu = np.abs(uf - np.round(uf)) < tol
    bv = np.abs(vf - np.round(vf)) < tol
    edge = bu | bv
    for su in (0, 1):
        for sv in (0, 1):
            _splat(out, np.where(bu, np.round(uf) - su, np.trunc(uf))[edge],
                   np.where(bv, np.round(vf) - sv, np.trunc(vf))[edge], r)
    return out


def excused_pixels(pos, eye, target, hw, point_size, slack=1e-4, rel=1e-12):
    """Pixels where the two renders may rightly differ: the edge pixels,
    and those where two splats within ``slack`` of the pixel's nearest
    depth have depths within ``rel`` of each other (a tie, ordered
    differently by the two sorts)."""
    H, W = hw
    r = point_size // 2
    out = edge_pixels(pos, eye, target, hw, r)
    uf, vf, z = _projection(pos, eye, target, hw)
    inb = (uf > -1) & (uf < W) & (vf > -1) & (vf < H)
    u, v, z = np.trunc(uf[inb]), np.trunc(vf[inb]), z[inb]
    pix, depth = [], []
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            pix.append(np.clip(v + dv, 0, H - 1) * W
                       + np.clip(u + du, 0, W - 1))
            depth.append(z)
    pix, depth = np.concatenate(pix).astype(np.int64), np.concatenate(depth)
    o = np.lexsort((depth, pix))
    pix, depth = pix[o], depth[o]
    first = np.r_[True, pix[1:] != pix[:-1]]
    nearest = depth[np.maximum.accumulate(
        np.where(first, np.arange(len(pix)), 0))]
    front = depth <= nearest + slack
    tie = np.r_[False, (pix[1:] == pix[:-1]) & front[1:] & front[:-1]
                & (depth[1:] - depth[:-1] <= rel * depth[1:])]
    out.reshape(-1)[pix[tie]] = True
    return out


def differing_share(pos, col, eye, target, point_size, hw=(720, 960)):
    """(share of covered pixels that differ, pixels that differ without an
    excuse)."""
    want = jh.render_points(pos, col, eye=eye, target=target, image_hw=hw,
                            point_size=point_size)
    got = th.render_points(pos, col, eye=eye, target=target, image_hw=hw,
                           point_size=point_size, device="cpu").numpy()
    bg = np.uint8(np.float32(BACKGROUND) * 255)
    covered = (want != bg).any(-1) | (got != bg).any(-1)
    differ = (want != got).any(-1)
    unexcused = differ & ~excused_pixels(pos, eye, target, hw, point_size)
    return differ.sum() / covered.sum(), int(unexcused.sum())


# measured: 8.5e-4 at point size 1, 3.2e-4 (51 of 160,607 pixels) at 3
LATTICE_SHARE = {1: 9e-4, 3: 4e-4}
RIG_HULL_SHARE = 1e-4  # measured 0 at every view


@pytest.mark.parametrize("point_size", [1, 3])
def test_render_points_on_a_lattice_differs_only_where_excused(point_size):
    """A 30³ integer lattice seen from the default eye: many depth ties,
    and the plane x = z on the image's centre column."""
    g = np.stack(np.meshgrid(*[np.arange(30)] * 3, indexing="ij"), -1)
    pos = (g.reshape(-1, 3) - 15).astype(np.float32)
    col = np.random.default_rng(5).uniform(0, 1, pos.shape).astype(
        np.float32)
    share, unexcused = differing_share(pos, col, *VIEWS["default"],
                                       point_size)
    print(f"lattice, point size {point_size}: {share:.3e} of the covered "
          "pixels differ")
    assert unexcused == 0 and share <= LATTICE_SHARE[point_size] <= 5e-3


@pytest.fixture(scope="module")
def rig_hull(rig):
    """The rig's 32³ hull in the viewer contract: the silhouettes of
    ``artifacts/final`` carved by the port, coloured by a ramp."""
    from PIL import Image

    masks = np.stack([np.asarray(Image.open(RIG_MASKS.format(i)))
                      for i in range(1, 5)])
    H, W = masks.shape[1:]
    yy, xx = np.mgrid[:H, :W]
    frames = np.stack([np.stack([xx % 256, yy % 256, np.full_like(xx, 40 * c)],
                                -1) for c in range(4)]).astype(np.uint8)
    recon = trec.Reconstructor(rig[0], tconfig.GridConfig(nx=32, ny=32,
                                                          nz=32),
                               tconfig.RigConfig(), device="cpu")
    pos, rgb = recon.carve_frame_compact(masks, frames)
    assert len(pos) > 500
    return pos, rgb


@pytest.mark.parametrize("view", list(VIEWS))
def test_render_points_on_the_rig_hull(rig_hull, view):
    share, unexcused = differing_share(*rig_hull, *VIEWS[view], 3)
    print(f"rig hull at 32^3, {view}: {share:.3e} of the covered pixels "
          "differ")
    assert unexcused == 0 and share <= RIG_HULL_SHARE


def test_excused_pixels_find_the_centre_column():
    """The excuse is narrow: on the lattice it is the splats of the x = z
    plane (the centre column) and the ties, a small part of the image."""
    g = np.stack(np.meshgrid(*[np.arange(30)] * 3, indexing="ij"), -1)
    pos = (g.reshape(-1, 3) - 15).astype(np.float32)
    ex = excused_pixels(pos, *VIEWS["default"], (720, 960), 1)
    assert ex[:, 479:481].any() and ex.mean() < 0.01


@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_png_round_trip(tmp_path, as_tensor):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (45, 67, 3), np.uint8)
    path = str(tmp_path / "sub" / "img.png")
    th.save_png(path, torch.from_numpy(img) if as_tensor else img)
    back = Image.open(path)
    assert back.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(back), img)
    with pytest.raises(ValueError, match="u8 RGB"):
        th.save_png(path, img.astype(np.int32))


# -- app: the lifted carve and surface, the floor --------------------------


H, W, K = 60, 80, 50
MASK_PARAMS = [dataclasses.replace(p, figure_threshold=30.0,
                                   inner_threshold=6.0)
               for p in tconfig.DEFAULT_MASK_PARAMS]
FG_BGR = np.array([30, 220, 250], np.uint8)


@dataclasses.dataclass
class SyntheticRig:
    data: str
    models: str
    frames: np.ndarray


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The synthetic rig at 60x80 as a data directory, background models
    as npz (schema 2, read by both packages) and 2 frames of a moving
    sphere."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("viewer_rig")
    cams = tsyn.synthetic_cameras(4, image_hw=(H, W), f=70.0)
    for i, cp in enumerate(cams, start=1):
        txml.save_camera_config(str(root / "data" / f"cam{i}"), cp.K,
                                cp.dist, cp.rvec, cp.tvec)
    bg = rng.integers(40, 200, size=(4, H, W, 3), dtype=np.uint8)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    for c in range(4):
        w = np.zeros((H, W, K), np.float32)
        w[..., :3] = rng.dirichlet([6.0, 3.0, 1.0], size=(H, W))
        mean = np.zeros((H, W, K, 3), np.float32)
        mean[..., :3, :] = (bg_hsv[c][:, :, None, :].astype(np.float32)
                            + rng.normal(0, 3, (H, W, 3, 3)))
        var = np.zeros((H, W, K), np.float32)
        var[..., :3] = rng.uniform(150.0, 600.0, (H, W, 3))
        tart.save_mog_state(
            str(root / "models" / f"mog_cam{c + 1}.npz"),
            MOGState(weight=torch.from_numpy(w), mean=torch.from_numpy(mean),
                     var=torch.from_numpy(var),
                     nframes=torch.tensor(40, dtype=torch.int32)))
    frames = []
    for i in range(2):
        fr = bg.copy()
        for c, cp in enumerate(cams):
            sil = tsyn.sphere_silhouette_mask(
                cp, np.array([60.0 + 50 * i, -40.0, -650.0]), 520.0,
                (H, W)) > 0
            fr[c][sil] = FG_BGR
        frames.append(fr)
    return SyntheticRig(str(root / "data"), str(root / "models"),
                       np.stack(frames))


GRID = dict(nx=32, ny=32, nz=32)


def _port_state(synthetic, frames):
    rig = tconfig.RigConfig(image_height=H, image_width=W)
    return tapp.ViewerState(
        source=ArraySource(frames),
        background=BackgroundPipeline(synthetic.data,
                                      cache_dir=synthetic.models,
                                      mask_params=MASK_PARAMS, device="cpu"),
        recon=trec.Reconstructor(trec.load_rig(synthetic.data),
                                 tconfig.GridConfig(**GRID), rig,
                                 device="cpu"))


def test_recarve_and_rebuild_surface_match_the_reference(synthetic):
    """``recarve`` / ``rebuild_surface`` on 2 frames at 32³ against
    ``vbr_tpu``'s ``BackgroundPipeline`` (the same npz models),
    ``carve_frame``, ``compact_voxels``, ``extract_mesh`` and
    ``surface_tris_to_viewer``, as its viewer's closures run them."""
    state = _port_state(synthetic, synthetic.frames)
    assert tapp.rebuild_surface(state) is None  # nothing carved yet
    grid = jconfig.GridConfig(**GRID)
    jpipe = jbackground.BackgroundPipeline(
        synthetic.data, mask_params=[jconfig.MaskParams(
            **dataclasses.asdict(p)) for p in MASK_PARAMS],
        cache_dir=synthetic.models)
    jr = jrec.Reconstructor(jrec.load_rig(synthetic.data), grid,
                            jconfig.RigConfig(image_height=H, image_width=W))
    xs, ys, zs = grid.axis_ranges()
    for frames in synthetic.frames:
        pos, rgb = tapp.recarve(state)
        masks = jpipe.masks_for_frames(frames)
        occ, col = jr.carve_frame(masks, frames)
        want_pos, want_rgb = jcarve.compact_voxels(occ, col, grid, 64.0)
        assert_same(pos, want_pos)
        assert_same(rgb, want_rgb)
        assert len(pos) > 50
        tris_mm, _ = jmc.extract_mesh(
            np.asarray(occ).reshape(grid.shape), origin=(xs[0], ys[0], zs[0]),
            spacing=(xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]))
        tris = tapp.rebuild_surface(state)
        assert len(tris) > 0
        assert_same(tris, jscene.surface_tris_to_viewer(tris_mm, 64.0))
    assert tapp.recarve(state) is None  # the end of the stream


class _FakeGlfw(types.SimpleNamespace):
    """glfw for a viewer without a display: the window closes at once and
    the callbacks are kept, so a test can press keys."""

    PRESS, KEY_ESCAPE, KEY_G, KEY_M, KEY_F = 1, 256, 71, 77, 70
    KEY_W, KEY_S, KEY_A, KEY_D = 87, 83, 65, 68
    CONTEXT_VERSION_MAJOR = CONTEXT_VERSION_MINOR = OPENGL_PROFILE = 0
    OPENGL_CORE_PROFILE = SAMPLES = 0

    def __getattr__(self, name):  # window_hint, make_context_current, ...
        return lambda *a, **k: True

    def set_key_callback(self, win, cb):
        self.key_cb = cb

    def window_should_close(self, win):
        return True


class _FakeGL:
    def __getattr__(self, name):
        return (lambda *a, **k: 1) if name.startswith("gl") else 0


class _Recorder:
    """Stands for a GL renderable: keeps what the viewer hands it."""

    made = []

    def __init__(self, *args, **kw):
        self.args, self.kw, self.count = args, kw, 0
        self.calls = {}
        _Recorder.made.append(self)

    def __getattr__(self, name):
        def record(*args):
            self.calls[name] = args
            self.count = len(args[0]) if args and hasattr(args[0],
                                                          "__len__") else 0
        return record


def _fake_gl(monkeypatch, eng):
    _Recorder.made = []
    fake = _FakeGlfw()
    monkeypatch.setitem(sys.modules, "glfw", fake)
    gl = _FakeGL()
    monkeypatch.setitem(sys.modules, "OpenGL", types.SimpleNamespace(GL=gl))
    monkeypatch.setitem(sys.modules, "OpenGL.GL", gl)
    for name in ("InstancedCubes", "HDRPipeline", "StaticMesh", "Lines",
                 "TexturedMesh", "Texture2D"):
        monkeypatch.setattr(eng, name, _Recorder)
    monkeypatch.setattr(eng, "compile_program", lambda *a: 1)
    return fake


def _small_rig(monkeypatch):
    """The viewer's fixed ``RigConfig()`` and default mask parameters
    replaced by the synthetic rig's: its image size and the thresholds
    that its small silhouettes pass."""
    monkeypatch.setattr(tapp, "RigConfig", lambda: tconfig.RigConfig(
        image_height=H, image_width=W))
    monkeypatch.setattr(tapp, "BackgroundPipeline", functools.partial(
        BackgroundPipeline, mask_params=MASK_PARAMS))


def _drawn_floor():
    """(the floor's instances as the engine keeps them, the textured
    floor's quad): the first truncated to its ``max_instances``."""
    floor = _Recorder.made[1]
    pos, col = floor.calls["set_instances"]
    quad = [r for r in _Recorder.made if "set_triangles" in r.calls
            and r.calls["set_triangles"][0].shape == (2, 3, 3)]
    return (pos[: floor.kw["max_instances"]], col[: floor.kw["max_instances"]],
            quad[0].calls["set_triangles"] if quad else None)


def test_the_viewer_floor_spans_width_by_depth(synthetic, tmp_path,
                                               monkeypatch):
    """At (world_width, world_depth) = (8, 6) the port's viewer draws
    ``floor_and_cam_instances(cams, 8, 6)`` and the (8, 6) textured quad;
    ``vbr_tpu``'s passes the width twice and draws the first 48 tiles of
    the (8, 8) floor and the (8, 8) quad (recorded in ROADMAP's Queue 3)."""
    from PIL import Image

    res = tmp_path / "resources" / "models"
    (tmp_path / "resources" / "textures").mkdir(parents=True)
    res.mkdir()
    Image.fromarray(np.full((4, 4, 3), 200, np.uint8)).save(
        tmp_path / "resources" / "textures" / "diffuse_grid.jpg", "PNG")
    config = tconfig.AppConfig(world_width=8, world_height=4, world_depth=6,
                               window_width=64, window_height=48)
    cams = trec.load_rig(synthetic.data)

    _fake_gl(monkeypatch, teng)
    _small_rig(monkeypatch)
    tapp.run_viewer(synthetic.data, config, str(res),
                    source=ArraySource(synthetic.frames),
                    cache_dir=synthetic.models, device="cpu")
    fp, fc, _, _ = tscene.floor_and_cam_instances(cams, 8, 6)
    pos, col, quad = _drawn_floor()
    assert_same(pos, fp)
    assert_same(col, fc)
    for a, b in zip(quad, tscene.floor_textured_tris(8, 6)):
        assert_same(a, b)

    _fake_gl(monkeypatch, jeng)
    monkeypatch.setattr(jbackground, "BackgroundPipeline",
                        lambda *a, **k: None)
    monkeypatch.setattr(jvideo, "MultiCameraSource", lambda *a, **k: None)
    japp.run_viewer(synthetic.data, jconfig.AppConfig(
        world_width=8, world_height=4, world_depth=6, window_width=64,
        window_height=48), str(res))
    fp8, fc8, _, _ = tscene.floor_and_cam_instances(cams, 8, 8)
    pos, col, quad = _drawn_floor()
    assert_same(pos, fp8[:48])
    assert not np.array_equal(pos, fp)
    for a, b in zip(quad, tscene.floor_textured_tris(8, 8)):
        assert_same(a, b)


def test_the_viewer_keys_carve_and_mesh(synthetic, monkeypatch):
    """``G`` shows the next frame's carve, ``M`` its surface, ``F`` and
    ``Escape`` flip their flags; without a source and without the rig's
    videos the viewer raises before it opens a window."""
    with pytest.raises(FileNotFoundError, match="video.avi"):
        tapp.run_viewer(synthetic.data, device="cpu")
    glfw = _fake_gl(monkeypatch, teng)
    _small_rig(monkeypatch)
    tapp.run_viewer(synthetic.data, tconfig.AppConfig(
        world_width=32, world_height=16, world_depth=32, window_width=64,
        window_height=48), source=ArraySource(synthetic.frames),
        cache_dir=synthetic.models, device="cpu")
    cubes, surface = _Recorder.made[0], _Recorder.made[3]
    want = _port_state(synthetic, synthetic.frames)
    press = lambda key: glfw.key_cb(None, key, 0, glfw.PRESS, 0)  # noqa: E731
    press(glfw.KEY_G)
    for a, b in zip(cubes.calls["set_instances"], tapp.recarve(want)):
        assert_same(a, b)
    assert "set_triangles" not in surface.calls
    press(glfw.KEY_M)
    assert_same(surface.calls["set_triangles"][0],
                tapp.rebuild_surface(want))
    press(glfw.KEY_G)  # the next frame, and its surface while M is on
    for a, b in zip(cubes.calls["set_instances"], tapp.recarve(want)):
        assert_same(a, b)
    assert_same(surface.calls["set_triangles"][0],
                tapp.rebuild_surface(want))
    press(glfw.KEY_G)  # past the end: nothing changes
    assert len(cubes.calls["set_instances"][0]) > 50
