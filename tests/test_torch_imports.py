"""The port and its chip script import nothing of JAX, cv2, matplotlib or
``vbr_tpu``."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "vbr_tpu_torch.apps.assignment_api",
    "vbr_tpu_torch.apps.cli",
    "vbr_tpu_torch.apps.manual_corners",
    "vbr_tpu_torch.models.visual_hull",
    "vbr_tpu_torch.native",
    "vbr_tpu_torch.native.build",
    "vbr_tpu_torch.ops._cuda",
    "vbr_tpu_torch.ops.camera",
    "vbr_tpu_torch.ops.carve",
    "vbr_tpu_torch.ops.carve_blocked",
    "vbr_tpu_torch.ops.ccl",
    "vbr_tpu_torch.ops.ccl_label",
    "vbr_tpu_torch.ops.color",
    "vbr_tpu_torch.ops.corners",
    "vbr_tpu_torch.ops.gmm",
    "vbr_tpu_torch.ops.marching_cubes",
    "vbr_tpu_torch.ops.morphology",
    "vbr_tpu_torch.ops.texturing",
    "vbr_tpu_torch.parallel",
    "vbr_tpu_torch.parallel.carve_sharded",
    "vbr_tpu_torch.parallel.mesh_sharded",
    "vbr_tpu_torch.parallel.pallas_sharded",
    "vbr_tpu_torch.parallel.pipeline_sharded",
    "vbr_tpu_torch.pipelines.auto_extrinsics",
    "vbr_tpu_torch.pipelines.background",
    "vbr_tpu_torch.pipelines.calibration",
    "vbr_tpu_torch.pipelines.extrinsics_eval",
    "vbr_tpu_torch.pipelines.photometric_calibration",
    "vbr_tpu_torch.pipelines.reconstruction",
    "vbr_tpu_torch.pipelines.reports",
    "vbr_tpu_torch.pipelines.validation",
    "vbr_tpu_torch.utils.artifacts",
    "vbr_tpu_torch.utils.config",
    "vbr_tpu_torch.utils.device",
    "vbr_tpu_torch.utils.imageproc",
    "vbr_tpu_torch.utils.preview",
    "vbr_tpu_torch.utils.profiling",
    "vbr_tpu_torch.utils.roi",
    "vbr_tpu_torch.utils.synthetic",
    "vbr_tpu_torch.utils.video",
    "vbr_tpu_torch.utils.warnings_",
    "vbr_tpu_torch.utils.xmlio",
    "vbr_tpu_torch.viewer",
    "vbr_tpu_torch.viewer.app",
    "vbr_tpu_torch.viewer.gl_engine",
    "vbr_tpu_torch.viewer.headless",
    "vbr_tpu_torch.viewer.models3d",
    "vbr_tpu_torch.viewer.offscreen",
    "vbr_tpu_torch.viewer.scene",
    "chip_smoke",
]
# the modules that import without PyOpenGL, glfw or PIL (the card's
# machine has no PyOpenGL or glfw)
GL_FREE = [
    "vbr_tpu_torch.viewer.models3d",
    "vbr_tpu_torch.viewer.scene",
    "vbr_tpu_torch.viewer.headless",
    "vbr_tpu_torch.viewer.gl_engine",
    "vbr_tpu_torch.utils.video",
    "vbr_tpu_torch.native",
    "vbr_tpu_torch.apps.cli",
    "vbr_tpu_torch.apps.manual_corners",
    "vbr_tpu_torch.pipelines.reports",
    "chip_smoke",
]


@pytest.mark.parametrize("blocked", ["jax", "vbr_tpu", "cv2", "matplotlib"])
def test_port_imports_without(blocked):
    code = (
        "import sys\n"
        f"sys.modules[{blocked!r}] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'vbr_tpu.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("blocked", ["OpenGL", "glfw", "PIL"])
def test_viewer_imports_without(blocked):
    """``models3d``, ``scene``, ``headless``, ``gl_engine``, the video
    module, the native module and the CLI import, and the headless
    renderer, ``save_png`` and an uncompressed AVI's round trip run, with
    ``blocked`` absent (and JAX, ``vbr_tpu`` and cv2 too)."""
    code = (
        "import sys\n"
        f"for name in ('jax', 'vbr_tpu', 'cv2', {blocked!r}):\n"
        "    sys.modules[name] = None\n"
        "import importlib, os, tempfile\n"
        f"for m in {GL_FREE!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from vbr_tpu_torch.viewer import headless\n"
        "img = headless.render_points(torch.zeros(1, 3) + 5, torch.ones(1, 3),"
        " image_hw=(8, 8))\n"
        "path = os.path.join(tempfile.mkdtemp(), 'x.png')\n"
        "headless.save_png(path, img)\n"
        "assert os.path.getsize(path) > 50\n"
        "import numpy as np\n"
        "from vbr_tpu_torch.utils import video\n"
        "avi = os.path.join(tempfile.mkdtemp(), 'x.avi')\n"
        "frame = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)\n"
        "with video.AviWriter(avi, 10.0, 7, 5, fourcc='BI_RGB') as w:\n"
        "    w.write(frame)\n"
        "assert (video.read_video(avi)[0] == frame).all()\n"
        f"assert sys.modules[{blocked!r}] is None\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_lib_path_follows_source_headers_and_flags(tmp_path):
    """A kernel's library is named by its source, the headers it lists and
    its flags: editing any of them names another library (no ``nvcc``
    needed to see that)."""
    from vbr_tpu_torch.ops._cuda import CudaKernel

    src, hdr = tmp_path / "k.cu", tmp_path / "k_common.cuh"
    src.write_text('#include "k_common.cuh"\n')
    hdr.write_text("// one\n")

    def kernel(deps=("k_common.cuh",), flags=()):
        k = CudaKernel("k.cu", "k", [], extra_flags=flags, deps=deps)
        k.source = src
        k.deps = [src.parent / d for d in deps]
        return k

    first = kernel().lib_path
    assert kernel().lib_path == first  # stable
    assert kernel(deps=()).lib_path != first  # the header is in the hash
    assert kernel(flags=("-DX=1",)).lib_path != first
    hdr.write_text("// two\n")
    second = kernel().lib_path
    assert second != first  # an edited header cannot load a stale build
    assert kernel(deps=()).lib_path == kernel(deps=()).lib_path
    src.write_text('#include "k_common.cuh"\n// edited\n')
    assert kernel().lib_path != second


def test_labelling_kernels_list_their_shared_header():
    from vbr_tpu_torch.ops import ccl_label

    for k in (ccl_label.K2, ccl_label.K5):
        assert [d.name for d in k.deps] == ["ccl_common.cuh"]
        assert all(d.exists() for d in k.deps)
        assert f'#include "{k.deps[0].name}"' in k.source.read_text()


def test_carve_kernels_list_their_shared_header():
    from vbr_tpu_torch.ops import carve_blocked

    for k in (carve_blocked.K1, carve_blocked.K4):
        assert [d.name for d in k.deps] == ["carve_common.cuh"]
        assert all(d.exists() for d in k.deps)
        assert f'#include "{k.deps[0].name}"' in k.source.read_text()
    assert carve_blocked.K1.lib_path != carve_blocked.K4.lib_path


def test_host_lib_path_follows_source_and_flags(tmp_path):
    """The host library is named by its source and its flags: editing
    either names another library."""
    from vbr_tpu_torch.native import build

    src = tmp_path / "h.cpp"
    src.write_text("// one\n")
    first = build.lib_path(src)
    assert first == build.lib_path(src) and first.parent == build.BUILD_DIR
    assert build.lib_path(src, build.FLAGS + ("-DX=1",)) != first
    src.write_text("// two\n")
    assert build.lib_path(src) != first
    assert build.lib_path().name.startswith("libvbr_host_")
    assert "-ffp-contract=off" in build.FLAGS
    assert not any(f.startswith("-march") for f in build.FLAGS)


@pytest.mark.parametrize("how", ["broken source", "no compiler"])
def test_host_lib_that_fails_to_build_raises(tmp_path, monkeypatch, how):
    """No numpy fallback: when the host library cannot be built, the pack
    and the emission raise."""
    import numpy as np

    from vbr_tpu_torch.native import build
    from vbr_tpu_torch.ops import color, marching_cubes

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "host")
    if how == "broken source":
        src = tmp_path / "vbr_host.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(build, "SOURCE", src)
        match = "g\\+\\+ failed"
    else:
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    with pytest.raises(RuntimeError, match=match):
        color.bgr_to_yuv420_host(np.zeros((1, 4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match=match):
        marching_cubes.triangles_from_wire(
            np.zeros(4, np.int32), np.ones(4, np.uint8), 4, (3, 3, 3))
    assert not (tmp_path / "host").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "host").iterdir())
