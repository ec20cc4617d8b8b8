"""The port and its chip script import nothing of JAX, cv2 or ``vbr_tpu``."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "vbr_tpu_torch.apps.assignment_api",
    "vbr_tpu_torch.models.visual_hull",
    "vbr_tpu_torch.ops._cuda",
    "vbr_tpu_torch.ops.camera",
    "vbr_tpu_torch.ops.carve",
    "vbr_tpu_torch.ops.carve_blocked",
    "vbr_tpu_torch.ops.ccl",
    "vbr_tpu_torch.ops.ccl_label",
    "vbr_tpu_torch.ops.color",
    "vbr_tpu_torch.ops.gmm",
    "vbr_tpu_torch.ops.marching_cubes",
    "vbr_tpu_torch.ops.morphology",
    "vbr_tpu_torch.ops.texturing",
    "vbr_tpu_torch.pipelines.background",
    "vbr_tpu_torch.pipelines.reconstruction",
    "vbr_tpu_torch.utils.artifacts",
    "vbr_tpu_torch.utils.config",
    "vbr_tpu_torch.utils.device",
    "vbr_tpu_torch.utils.synthetic",
    "vbr_tpu_torch.utils.video",
    "vbr_tpu_torch.utils.xmlio",
    "chip_smoke",
]


@pytest.mark.parametrize("blocked", ["jax", "vbr_tpu", "cv2"])
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
