"""The port's CLI (``vbr_tpu_torch/apps/cli.py``) against ``vbr_tpu``'s on
the same on-disk rig, the counterpart of ``tests/test_cli.py``.

One synthetic 4-camera rig directory of MJPEG AVI files (written by the
port's ``VideoSink``) per module; each command of either package runs once
(module fixtures).  ``vbr_tpu`` decodes with OpenCV, whose default FFmpeg
reader upsamples JPEG chroma differently from OpenCV's own MJPEG reader
(up to 12 levels): here ``cv2.VideoCapture`` is made to use
``cv2.CAP_OPENCV_MJPEG`` and ``vbr_tpu.native.PrefetchingSource`` (C++ over
FFmpeg) a Python source over it, so both packages see the same frames, as
the port's reader gives them (``tests/test_torch_video.py``).  Each
package trains a directory's models from video once; later models of the
directory reuse them (``_trained_once``).  Outputs are
compared bit for bit: masks, PLY and OBJ files, the rendered PNG (the
splat renderer's lattice tolerance of ``tests/test_torch_viewer.py`` is
allowed, and is not needed here), the background cache both ways and the
trained states (within ``JIT_ULP`` of ``vbr_tpu``'s jitted training, as in
``tests/test_torch_gmm_train.py``); the calibrations within the tolerances
of ``tests/test_torch_photometric.py`` and
``tests/test_torch_extrinsics.py``."""

import contextlib
import io
import os
import re
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from vbr_tpu import native as jnative
from vbr_tpu.apps import cli as jcli
from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import carve_pallas as jcarve_pallas
from vbr_tpu.utils import xmlio as jxml
from vbr_tpu_torch import native
from vbr_tpu_torch.apps import assignment_api as tapi
from vbr_tpu_torch.apps import cli
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import synthetic as tsyn
from vbr_tpu_torch.utils import video as tvio
from vbr_tpu_torch.utils import xmlio as txml
from vbr_tpu_torch.utils.config import CameraParams, GridConfig

from tests.test_torch_gmm_train import JIT_ULP, _ulp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_HW = (486, 644)  # RigConfig()'s: the CLIs' models assume it
GRID = "32"
BG_FRAMES, VIDEO_FRAMES = 2, 3
_CAPTURE = cv2.VideoCapture


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trained_once(cls, store):
    """``cls.train_background`` that trains on a directory's videos once
    and hands later models of the same directory the same states (the
    CPU's plain training of four cameras at 486x644 takes a while; the
    first training from video is the one every later model gets)."""
    train = cls.train_background

    def train_background(self, source):
        if not isinstance(source, (str, os.PathLike)):
            return train(self, source)
        key = os.fspath(source)
        if key not in store:
            train(self, source)
            store[key] = (list(self.bg_states), list(self.mog_params))
        self.bg_states, self.mog_params = (list(x) for x in store[key])
        if isinstance(self, tvh.VisualHull):
            self._stage = None
        elif hasattr(self, "_stacked_fz"):
            self._stacked_fz = None

    return train_background


@pytest.fixture(autouse=True, scope="module")
def _train_once():
    with pytest.MonkeyPatch.context() as mp:
        for cls in (tvh.VisualHull, jvh.VisualHull):
            mp.setattr(cls, "train_background", _trained_once(cls, {}))
        yield


class _OpenCVMJPEGSource:
    """``vbr_tpu.native.PrefetchingSource``'s interface over OpenCV's MJPEG
    reader."""

    def __init__(self, paths, queue_capacity=8):
        self.caps = [_CAPTURE(p, cv2.CAP_OPENCV_MJPEG) for p in paths]
        if not all(c.isOpened() for c in self.caps):
            raise FileNotFoundError(f"cannot open videos: {list(paths)}")

    def next_frames(self):
        frames = []
        for cap in self.caps:
            ok, f = cap.read()
            if not ok:
                return None
            frames.append(f)
        return np.stack(frames)

    def close(self):
        for cap in self.caps:
            cap.release()


@contextlib.contextmanager
def reference_readers():
    """``vbr_tpu`` decoding through OpenCV's MJPEG reader, and its
    multi-frame Pallas carve (``carve --batched``) in interpret mode, as
    its own tests run Pallas on the CPU."""
    carve = jcarve_pallas.carve_frames_blocked
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cv2, "VideoCapture",
                   lambda path, *a: _CAPTURE(path, cv2.CAP_OPENCV_MJPEG))
        mp.setattr(jnative, "PrefetchingSource", _OpenCVMJPEGSource)
        mp.setattr(jcarve_pallas, "carve_frames_blocked",
                   lambda *a, **k: carve(*a, interpret=True, **k))
        yield


def _run(main, argv):
    """Run one CLI command; its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _sphere_frames(cams, bg, centers):
    out = []
    for center in centers:
        fr = np.repeat(bg[None], len(cams), 0)
        for c, cp in enumerate(cams):
            sil = tsyn.sphere_silhouette_mask(
                cp, np.asarray(center), 500.0, IMG_HW) > 0
            fr[c][sil] = (200, 40, 160)
        out.append(fr)
    return out


@pytest.fixture(scope="module")
def rig_dir(tmp_path_factory):
    """4 cameras: config.xml, checkerboard.xml, background.avi (a noisy
    still) and video.avi (a sphere that moves), MJPEG."""
    root = tmp_path_factory.mktemp("rig")
    H, W = IMG_HW
    cams = tsyn.synthetic_cameras(4, image_hw=IMG_HW)
    rng = np.random.default_rng(0)
    bg = rng.integers(40, 200, size=(H, W, 3), dtype=np.uint8)
    txml.save_storage(str(root / "checkerboard.xml"),
                      {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
                       "CheckerBoardSquareSize": 115})
    video = _sphere_frames(cams, bg, [(100.0 + 40 * t, -50.0, -700.0)
                                      for t in range(VIDEO_FRAMES)])
    for i, cp in enumerate(cams, start=1):
        d = root / f"cam{i}"
        txml.save_camera_config(str(d), cp.K, np.zeros(5), cp.rvec, cp.tvec)
        with native.VideoSink(str(d / "background.avi"), 10.0, W, H) as s:
            for _ in range(BG_FRAMES):
                s.write(np.clip(bg + rng.integers(-3, 4, bg.shape), 0, 255)
                        .astype(np.uint8))
        with native.VideoSink(str(d / "video.avi"), 10.0, W, H) as s:
            for fr in video:
                s.write(fr[i - 1])
    return str(root)


COMMANDS = {
    "masks": ["masks"],
    "carve": ["carve", "--grid", GRID, "--ply", "{out}/hull.ply"],
    "batched": ["carve", "--grid", GRID, "--batched", "--frames",
                str(VIDEO_FRAMES), "--ply", "{out}/b"],
    "mesh": ["mesh", "--grid", GRID, "--obj", "{out}/hull.obj"],
    "render": ["render", "--grid", GRID, "--png", "{out}/render.png"],
    "stream": ["pipeline", "--grid", GRID, "--frames", str(VIDEO_FRAMES),
               "--ply", "{out}/stream.ply"],
    "offline": ["pipeline", "--grid", GRID, "--frames", str(VIDEO_FRAMES),
                "--offline", "2", "--ply", "{out}/offline.ply"],
}


def _commands(main, rig, out, names=tuple(COMMANDS)):
    lines = {}
    for name in names:
        argv = [a.format(out=out) for a in COMMANDS[name]]
        lines[name] = [ln.replace(out, "OUT") for ln in _run(
            main, argv + ["--cpu", "--data", rig, "--out-dir", out])]
    return lines


@pytest.fixture(scope="module")
def reference(rig_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_out"))
    with reference_readers():
        return out, _commands(jcli.main, rig_dir, out)


@pytest.fixture(scope="module")
def port(rig_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_out"))
    return out, _commands(cli.main, rig_dir, out)


def _timeless(lines):
    """The printed lines without the times in them."""
    return [re.sub(r"[0-9.]+ ?(s|ms/frame|fps)\b", "T", ln) for ln in lines]


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_cli_masks(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert tl["masks"] == jl["masks"]
    for c in range(1, 5):
        want = cv2.imread(os.path.join(jout, f"mask_cam{c}.png"),
                          cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(tout, f"mask_cam{c}.png"),
                         cv2.IMREAD_UNCHANGED)
        assert got.shape == IMG_HW and got.dtype == np.uint8
        assert 0.01 < (got > 0).mean() < 0.2
        np.testing.assert_array_equal(got, want)
    assert sorted(os.listdir(os.path.join(tout, "bg_cache"))) == [
        f"mog_cam{c}.npz" for c in range(1, 5)]


def test_cli_carve_writes_ply(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert _timeless(tl["carve"]) == _timeless(jl["carve"])
    assert _same_file(os.path.join(tout, "hull.ply"),
                      os.path.join(jout, "hull.ply"))
    assert "element vertex 0" not in open(os.path.join(tout, "hull.ply")).read()


def test_cli_carve_batched_writes_a_ply_per_frame(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert _timeless(tl["batched"]) == _timeless(jl["batched"])
    counts = set()
    for i in range(VIDEO_FRAMES):
        assert _same_file(os.path.join(tout, f"b.{i}.ply"),
                          os.path.join(jout, f"b.{i}.ply"))
        counts.add(open(os.path.join(tout, f"b.{i}.ply")).read().count("\n"))
    assert len(counts) > 1  # the sphere moves


def test_cli_mesh_writes_obj(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert tl["mesh"] == jl["mesh"]
    assert _same_file(os.path.join(tout, "hull.obj"),
                      os.path.join(jout, "hull.obj"))


def test_cli_render_headless_png(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert tl["render"] == jl["render"]
    want = cv2.imread(os.path.join(jout, "render.png"))
    got = cv2.imread(os.path.join(tout, "render.png"))
    assert got.shape == (720, 960, 3) and got.std() > 1.0
    np.testing.assert_array_equal(got, want)


def test_cli_pipeline_stream(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert _timeless(tl["stream"]) == _timeless(jl["stream"])
    assert tl["stream"][-1].startswith(f"{VIDEO_FRAMES} frames: ")
    assert _same_file(os.path.join(tout, "stream.ply"),
                      os.path.join(jout, "stream.ply"))


def test_cli_pipeline_offline(reference, port):
    (jout, jl), (tout, tl) = reference, port
    assert _timeless(tl["offline"]) == _timeless(jl["offline"])
    assert _same_file(os.path.join(tout, "offline.ply"),
                      os.path.join(jout, "offline.ply"))
    # frame 0 of the offline path is frame 0 of the stream
    assert _same_file(os.path.join(tout, "offline.ply"),
                      os.path.join(tout, "stream.ply"))


def test_cli_render_animate_avi(rig_dir, port, tmp_path):
    """``--animate N`` renders N frames along the orbit into an MJPEG AVI
    (``.avi`` whatever extension ``--png`` names); each frame is the JPEG
    of the splat render of that frame's carve."""
    from vbr_tpu_torch.pipelines import background, reconstruction
    from vbr_tpu_torch.utils.config import RigConfig
    from vbr_tpu_torch.viewer import headless

    tout = port[0]
    out = str(tmp_path / "anim.mp4")
    lines = _run(cli.main, ["render", "--cpu", "--data", rig_dir,
                            "--out-dir", tout, "--grid", GRID, "--animate",
                            "2", "--png", out])
    avi = str(tmp_path / "anim.avi")
    assert lines == [f"wrote {avi} (2 frames, orbit render)"]
    got = tvio.read_video(avi)
    assert got.shape == (2, 720, 1280, 3)
    g = GridConfig(nx=32, ny=32, nz=32)
    cams = reconstruction.load_rig(rig_dir)
    recon = reconstruction.Reconstructor(cams, g, RigConfig(), device="cpu")
    pipe = background.BackgroundPipeline(
        rig_dir, cache_dir=os.path.join(tout, "bg_cache"), device="cpu")
    frames = tvio.MultiCameraSource(rig_dir).next_frames()
    pos, col = recon.carve_frame_compact(pipe.masks_for_frames(frames),
                                         frames)
    eye, _, _ = cli.orbit_pose(-135.0)
    img = headless.render_points(pos, col, eye=eye, target=(4.0, 6.0, 0.0),
                                 image_hw=(720, 1280), device="cpu")
    headless.render_floor_and_cameras(img, *cli._floor_and_cameras(cams),
                                      eye=eye, target=(4.0, 6.0, 0.0))
    bgr = np.ascontiguousarray(img.numpy()[..., ::-1])
    np.testing.assert_array_equal(
        got[0], tvio.decode_jpeg(tvio.encode_jpeg(bgr)))
    assert got[0].std() > 1.0 and not np.array_equal(got[0], got[1])


def _with_cache(tmp_path, name, cache_from):
    out = tmp_path / name
    shutil.copytree(os.path.join(cache_from, "bg_cache"), out / "bg_cache")
    return str(out)


def test_the_background_cache_crosses_the_packages(rig_dir, reference, port,
                                                   tmp_path):
    """The port's ``masks`` on ``vbr_tpu``'s ``bg_cache`` and ``vbr_tpu``'s
    on the port's: the masks of either package's own run."""
    (jout, _), (tout, _) = reference, port
    on_j = _with_cache(tmp_path, "port_on_jax", jout)
    on_t = _with_cache(tmp_path, "jax_on_port", tout)
    _run(cli.main, ["masks", "--cpu", "--data", rig_dir, "--out-dir", on_j])
    with reference_readers():
        _run(jcli.main, ["masks", "--cpu", "--data", rig_dir, "--out-dir",
                         on_t])
    for c in range(1, 5):
        name = f"mask_cam{c}.png"
        want = cv2.imread(os.path.join(jout, name), cv2.IMREAD_UNCHANGED)
        for d in (on_j, on_t):
            np.testing.assert_array_equal(
                cv2.imread(os.path.join(d, name), cv2.IMREAD_UNCHANGED),
                want)
    # neither run trained: the caches are the ones copied
    for d, src in ((on_j, jout), (on_t, tout)):
        for c in range(1, 5):
            assert _same_file(os.path.join(d, "bg_cache", f"mog_cam{c}.npz"),
                              os.path.join(src, "bg_cache",
                                           f"mog_cam{c}.npz"))


def test_from_data_dir_trains_as_vbr_tpu(rig_dir, reference, port):
    """``from_data_dir(train_background=True)`` trains each camera on its
    ``background.avi``: the port's ``masks`` cache exactly, ``vbr_tpu``'s
    (its jitted training) within ``JIT_ULP``."""
    (jout, _), (tout, _) = reference, port
    model = tvh.VisualHull.from_data_dir(rig_dir,
                                         GridConfig(nx=32, ny=32, nz=32),
                                         device="cpu")
    assert [p.history for p in model.mog_params] == [BG_FRAMES] * 4
    for c, st in enumerate(model.bg_states, start=1):
        own = tart.load_mog_state(
            os.path.join(tout, "bg_cache", f"mog_cam{c}.npz"), device="cpu")
        with np.load(os.path.join(jout, "bg_cache", f"mog_cam{c}.npz")) as j:
            for name in ("weight", "mean", "var"):
                assert torch.equal(getattr(st, name), getattr(own, name))
                assert _ulp(getattr(st, name).numpy(), j[name]) <= JIT_ULP
            assert int(st.nframes) == int(j["nframes"]) == BG_FRAMES


def test_configure_and_run_viewer_on_the_rig_directory(rig_dir, port,
                                                       monkeypatch):
    """``assignment_api.configure(data_dir)`` (the rig's videos, training
    on ``background.avi``) gives the lists of its explicit form (decoded
    frames and the port's cache, trained on the same videos);
    ``run_viewer(data_dir)`` carves what ``source=`` carves."""
    from tests import test_torch_viewer as tv
    from vbr_tpu_torch.utils.video import ArraySource
    from vbr_tpu_torch.viewer import app as tapp
    from vbr_tpu_torch.viewer import gl_engine as teng

    tout = port[0]
    frames = np.stack([tvio.read_video(os.path.join(
        rig_dir, f"cam{c}", "video.avi")) for c in range(1, 5)], 1)
    size = (32, 16, 32)
    try:
        outs = {}
        for form, args in (
                ("data_dir", ()),
                ("explicit", (ArraySource(frames),
                              os.path.join(tout, "bg_cache")))):
            tapi.configure(rig_dir, *args, device="cpu")
            outs[form] = [tapi.set_voxel_positions(*size)
                          for _ in range(VIDEO_FRAMES + 1)]
        assert outs["data_dir"] == outs["explicit"]
        assert outs["data_dir"][-1] == ([], [])
        assert all(len(p) > 50 for p, _ in outs["data_dir"][:-1])
    finally:
        tapi.configure(None, None, None)

    config = tv.tconfig.AppConfig(world_width=32, world_height=16,
                                  world_depth=32, window_width=64,
                                  window_height=48)
    got = {}
    for form, kw in (("data_dir", {}),
                     ("explicit", {"source": ArraySource(frames)})):
        glfw = tv._fake_gl(monkeypatch, teng)
        tapp.run_viewer(rig_dir, config, cache_dir=os.path.join(
            tout, "bg_cache"), device="cpu", **kw)
        glfw.key_cb(None, glfw.KEY_G, 0, glfw.PRESS, 0)
        got[form] = tv._Recorder.made[0].calls["set_instances"]
    for a, b in zip(got["data_dir"], got["explicit"]):
        np.testing.assert_array_equal(a, b)
    pos = got["data_dir"][0]
    assert len(pos) > 50
    np.testing.assert_array_equal(pos, np.asarray(outs["explicit"][0][0],
                                                  np.float32))


def test_version_and_module_entry_point():
    import subprocess

    res = subprocess.run([sys.executable, "-m", "vbr_tpu_torch.apps.cli",
                          "--version"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("vbr-tpu-torch ")


def test_commands_default_to_the_card(rig_dir, tmp_path):
    """Without ``--cpu`` a command runs on the card, and raises where
    there is none: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="[Cc][Uu][Dd][Aa]"):
        cli.main(["masks", "--data", rig_dir, "--out-dir", str(tmp_path)])


def test_preview_warns_once(rig_dir, port, tmp_path, caplog):
    """``--preview MS``: no window toolkit, so the first preview warns
    (``preview_unavailable``) and the rest do nothing."""
    from vbr_tpu_torch.utils import preview

    out = _with_cache(tmp_path, "preview", port[0])
    preview._DISABLED = False
    with caplog.at_level("WARNING", logger="vbr_tpu"):
        _run(cli.main, ["masks", "--cpu", "--data", rig_dir, "--out-dir",
                        out, "--preview", "5"])
    warned = [r for r in caplog.records if "preview" in r.getMessage()]
    assert len(warned) == 1
    assert preview.show_result("x", np.zeros((2, 2), np.uint8), 5) is False


# -- calibration ---------------------------------------------------------------


@pytest.fixture(scope="module")
def board_dir(tmp_path_factory):
    """``tests/test_cli.py``'s board directory (cam1's rendered
    checkerboard at twice the resolution) written as MJPEG."""
    import test_photometric_calibration as tpc

    root = tmp_path_factory.mktemp("boards")
    jxml.save_storage(
        str(root / "checkerboard.xml"),
        {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
         "CheckerBoardSquareSize": tpc.SQUARE})
    K2 = tpc.K_TRUE.copy()
    K2[:2] *= 2.0
    W2, H2 = tpc.IMG_W * 2, tpc.IMG_H * 2
    with native.VideoSink(str(root / "cam1" / "checkerboard.avi"), 10.0, W2,
                          H2) as sink:
        for rv, tv in tpc._poses():
            sink.write(tpc.render_board(K2, np.zeros(5), rv, tv, ss=2,
                                        size=(W2, H2)))
    return str(root), K2


def _calibrate(main, root, out, extra):
    return _run(main, ["calibrate", "--cpu", "--data", root, "--out-dir",
                       out, "--cams", "1", "--video", "checkerboard.avi",
                       "--frame-interval", "1"] + extra)


def test_cli_calibrate_intrinsics_corners(board_dir, tmp_path, monkeypatch):
    """The corners route: the port converts to grey with
    ``ops.color.bgr_to_gray_u8`` (f32, rounded half to even) where
    ``vbr_tpu`` calls ``cv2.cvtColor`` (fixed point), which move a grey
    level by one here and there; the views found are the same and the
    intrinsics agree within 0.05 px (``tests/test_torch_photometric.py``'s
    bound on K) and meet ``tests/test_cli.py``'s bounds on the truth.  Both
    write ``intrinsic_params_cam1.png`` at the same size, from the same
    figure description (``tests/test_torch_reports.py``'s fields: text
    and ticks equal, the values within the calibrations' bounds).  The
    annotated video is an MJPEG AVI of every sampled frame."""
    import test_torch_reports as ttr
    from vbr_tpu.pipelines import reports as jreports
    from vbr_tpu_torch.pipelines import reports as treports

    figs, save, describe = {}, jreports._savefig, \
        treports.intrinsic_results_figure

    def grab(fig, out_path):
        save(fig, out_path)
        figs["vbr_tpu"] = ttr.mpl_description(fig)

    def record(runs):
        fig = describe(runs)
        figs["port"] = ttr.port_description(fig)
        return fig

    monkeypatch.setattr(jreports, "_savefig", grab)
    monkeypatch.setattr(treports, "intrinsic_results_figure", record)
    root, K2 = board_dir
    jo, to = str(tmp_path / "j"), str(tmp_path / "t")
    with reference_readers():
        jl = _calibrate(jcli.main, root, jo, ["--no-annotate"])
    tl = _calibrate(cli.main, root, to, [])
    assert tl[0] == jl[0]  # the same number of views with corners
    Kj = jxml.load_camera_config(os.path.join(jo, "cam1"))[0]
    Kt = txml.load_camera_config(os.path.join(to, "cam1"))[0]
    assert np.abs(Kt - Kj).max() <= 0.05
    assert abs(Kt[0, 0] - K2[0, 0]) / K2[0, 0] < 0.02
    assert abs(Kt[1, 2] - K2[1, 2]) < 6.0
    assert not any("skipped" in ln for ln in tl)
    pngs = [os.path.join(d, "intrinsic_params_cam1.png") for d in (jo, to)]
    assert ttr.png_size(pngs[0]) == ttr.png_size(pngs[1]) == (1800, 500)
    for a, b in zip(figs["vbr_tpu"], figs["port"]):
        for key in ("title", "xlabel", "xticks", "yticks", "yoffset",
                    "legend"):
            assert a[key] == b[key], key
        assert [t[:2] for t in a["bars"]] == [t[:2] for t in b["bars"]]
        np.testing.assert_allclose([t[2] for t in a["bars"]],
                                   [t[2] for t in b["bars"]], atol=0.05)
        for (x0, y0), (x1, y1) in zip(a["lines"], b["lines"]):
            np.testing.assert_array_equal(np.asarray(x0, float), x1)
            np.testing.assert_allclose(np.asarray(y0, float), y1, atol=0.05)
    board_props = tvio.video_properties(
        os.path.join(root, "cam1", "checkerboard.avi"))
    assert tvio.video_properties(os.path.join(
        to, "cam1", "checkerboard_imagepoints.avi")) == board_props


def test_cli_calibrate_intrinsics_photometric(board_dir, tmp_path):
    """The photometric route on a video path: K within 0.05 px of
    ``vbr_tpu``'s over the same 60 steps (``tests/test_torch_photometric.py``'s
    bound) and within ``tests/test_cli.py``'s 10 % of the truth."""
    root, K2 = board_dir
    jo, to = str(tmp_path / "j"), str(tmp_path / "t")
    extra = ["--method", "photometric", "--photometric-iters", "60"]
    with reference_readers():
        jl = _calibrate(jcli.main, root, jo, extra)
    tl = _calibrate(cli.main, root, to, extra)
    assert tl[0].split(",")[0] == jl[0].split(",")[0]  # views
    Kj = jxml.load_camera_config(os.path.join(jo, "cam1"))[0]
    Kt = txml.load_camera_config(os.path.join(to, "cam1"))[0]
    assert np.abs(Kt - Kj).max() <= 0.05
    assert abs(Kt[0, 0] - K2[0, 0]) / K2[0, 0] < 0.10
    assert os.path.exists(os.path.join(to, "cam1", "photometric_calib.npz"))


@pytest.fixture(scope="module")
def extrinsics_dir(tmp_path_factory):
    """``chip_smoke``'s phase-20 scene at half resolution, two cameras:
    each camera's intrinsics in config.xml and its board, background and
    person frames as MJPEG videos."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    sc = chip_smoke.extrinsics_scene(torch, torch.device("cpu"), (244, 322),
                                     2, bg_frames=8)
    root = tmp_path_factory.mktemp("ext_rig")
    txml.save_storage(str(root / "checkerboard.xml"),
                      {"CheckerBoardWidth": 8, "CheckerBoardHeight": 6,
                       "CheckerBoardSquareSize": 115})
    for i, cp in enumerate(sc.cams, start=1):
        d = root / f"cam{i}"
        txml.save_camera_config(str(d), cp.K, cp.dist, np.zeros(3),
                                np.zeros(3))
        for name, frames in (("checkerboard.avi", sc.boards[i - 1]),
                             ("background.avi", sc.backs[i - 1]),
                             ("video.avi", sc.person[i - 1][None])):
            with native.VideoSink(str(d / name), 10.0, 322, 244) as sink:
                for f in frames:
                    sink.write(f)
    return str(root), sc, chip_smoke


def test_cli_calibrate_extrinsics(extrinsics_dir, tmp_path):
    """``calibrate --mode extrinsics`` (full auto, 400 photometric steps):
    the same flips and votes as ``vbr_tpu``'s command, poses within
    ``tests/test_torch_extrinsics.py``'s refinement tolerance (1e-6 rad,
    1e-3 mm), and within 0.01 rad and 25 mm of the scene's poses in the
    nearer global frame; the annotated still of each camera."""
    root, sc, cs = extrinsics_dir
    jo, to = str(tmp_path / "j"), str(tmp_path / "t")
    argv = ["calibrate", "--cpu", "--data", root, "--mode", "extrinsics",
            "--cams", "1,2", "--out-dir"]
    with reference_readers():
        jl = _run(jcli.main, argv + [jo])
    tl = _run(cli.main, argv + [to])
    assert tl[-1] == jl[-1] and tl[-1].startswith("orientation vote: {")
    got = []
    for c in (1, 2):
        _, _, rj, tj = jxml.load_camera_config(os.path.join(jo, f"cam{c}"))
        K, dist, rt, tt = txml.load_camera_config(os.path.join(to, f"cam{c}"))
        assert np.abs(rt - rj).max() <= 1e-6
        assert np.abs(tt - tj).max() <= 1e-3
        got.append(CameraParams.from_arrays(K, dist, rt, tt))
        still = os.path.join(to, f"cam{c}", "checkerboard_imagepoints.jpg")
        assert cv2.imread(still).shape == (244, 322, 3)
    errs, _ = cs.pose_errors(got, sc.cams)
    assert all(r < 0.01 and t < 25.0 for r, t in errs), errs


def test_cli_calibrate_extrinsics_no_auto(board_dir, tmp_path):
    """``calibrate --mode extrinsics --no-auto`` (per-frame saddle
    detection and PnP-RANSAC) on the board directory with cam1's
    intrinsics: the same printed lines as ``vbr_tpu``'s (one camera: the
    note on the board's symmetry, then the pose), the pose within
    ``tests/test_torch_extrinsics.py``'s tolerance (1e-6 rad, 1e-3 mm), and
    the annotated still."""
    root, K2 = board_dir
    rig = str(tmp_path / "rig")
    shutil.copytree(root, rig)
    txml.save_camera_config(os.path.join(rig, "cam1"), K2, np.zeros(5),
                            np.zeros(3), np.zeros(3))
    jo, to = str(tmp_path / "j"), str(tmp_path / "t")
    argv = ["calibrate", "--cpu", "--data", rig, "--mode", "extrinsics",
            "--cams", "1", "--no-auto", "--out-dir"]
    with reference_readers():
        jl = _run(jcli.main, argv + [jo])
    tl = _run(cli.main, argv + [to])
    assert [ln.replace(to, "OUT") for ln in tl] == \
        [ln.replace(jo, "OUT") for ln in jl]
    assert tl[-1].startswith("cam1: pose from frame 0, reproj ")
    _, _, rj, tj = jxml.load_camera_config(os.path.join(jo, "cam1"))
    _, _, rt, tt = txml.load_camera_config(os.path.join(to, "cam1"))
    assert np.abs(rt - rj).max() <= 1e-6
    assert np.abs(tt - tj).max() <= 1e-3
    still = cv2.imread(os.path.join(to, "cam1",
                                    "checkerboard_imagepoints.jpg"))
    assert still.shape == cv2.imread(os.path.join(
        jo, "cam1", "checkerboard_imagepoints.jpg")).shape


def test_path_forms_equal_vbr_tpus(extrinsics_dir, tmp_path):
    """The readers on a path and a rig directory give ``vbr_tpu``'s
    results on the same MJPEG files: ``temporal_mean_gray``,
    ``median_background``, ``quick_person_masks(data_dir)`` and
    ``validation.test_camera_parameters_with_image`` (its drawn frame; the
    port writes the JPEG through PIL)."""
    from vbr_tpu.pipelines import auto_extrinsics as jax_ax
    from vbr_tpu.pipelines import validation as jval
    from vbr_tpu_torch.pipelines import auto_extrinsics as ax
    from vbr_tpu_torch.pipelines import validation as tval

    root, sc, _ = extrinsics_dir
    rig = str(tmp_path / "rig")  # cam1 at the scene's pose, to draw with
    shutil.copytree(root, rig)
    cp = sc.cams[0]
    txml.save_camera_config(os.path.join(rig, "cam1"), cp.K, cp.dist,
                            cp.rvec, cp.tvec)
    board = os.path.join(root, "cam1", "checkerboard.avi")
    back = os.path.join(root, "cam2", "background.avi")
    with reference_readers():
        want = (jax_ax.temporal_mean_gray(board),
                jax_ax.median_background(back),
                jax_ax.quick_person_masks(root, 2, cam_indices=[2, 1]),
                jval.test_camera_parameters_with_image(
                    rig, 1, str(tmp_path / "j.jpg"), draw="cube"))
    got = (ax.temporal_mean_gray(board), ax.median_background(back),
           ax.quick_person_masks(root, 2, cam_indices=[2, 1], device="cpu"),
           tval.test_camera_parameters_with_image(
               rig, 1, str(tmp_path / "t.jpg"), draw="cube"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (2, 244, 322) and (got[2] > 0).any()
    np.testing.assert_array_equal(ax.temporal_mean_gray(board),
                                  ax.temporal_mean_gray(
                                      tvio.frame_iterator(board)))
    assert cv2.imread(str(tmp_path / "t.jpg")).shape == (244, 322, 3)


_CAMS = [CameraParams(fx=500.0, fy=500.0, cx=160.0, cy=120.0)] * 2
_FRAMES = [np.zeros((8, 8, 3), np.uint8)]


@pytest.mark.parametrize("call", [
    # a path with frames where vbr_tpu's form has num_cameras
    lambda ax: ax.quick_person_masks("rig", _FRAMES, device="cpu"),
    lambda ax: ax.quick_person_masks("rig", 2, num_cameras=2, device="cpu"),
    lambda ax: ax.quick_person_masks(_FRAMES, _FRAMES, device="cpu",
                                     cam_indices=[1]),
    # frames beside a path, a path without cameras, cameras of another kind
    lambda ax: ax.auto_extrinsics("rig", _FRAMES, cameras=_CAMS,
                                  device="cpu"),
    lambda ax: ax.auto_extrinsics("rig", _CAMS, _FRAMES, device="cpu"),
    lambda ax: ax.auto_extrinsics("rig", device="cpu"),
    lambda ax: ax.auto_extrinsics("rig", [1, 2], device="cpu"),
    lambda ax: ax.auto_extrinsics([_FRAMES], [_FRAMES], None, _CAMS[:1],
                                  device="cpu", cam_indices=[2]),
], ids=["qpm-frames", "qpm-num-twice", "qpm-arrays-cam-indices",
        "ax-frames-and-cameras", "ax-person-frames", "ax-no-cameras",
        "ax-not-cameras", "ax-arrays-cam-indices"])
def test_path_forms_refuse_misplaced_arguments(call):
    """The readers' two forms share one body: on a path the slots that the
    array form uses for frames must hold what ``vbr_tpu``'s path form puts
    there (``num_cameras``, the cameras), and the path form's keywords do
    not stand beside arrays; anything else raises ``TypeError`` before a
    file is opened."""
    from vbr_tpu_torch.pipelines import auto_extrinsics as ax

    with pytest.raises(TypeError):
        call(ax)
