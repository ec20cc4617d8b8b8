"""The port and its chip script import nothing of JAX, cv2 or ``vbr_tpu``."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "vbr_tpu_torch.models.visual_hull",
    "vbr_tpu_torch.ops._cuda",
    "vbr_tpu_torch.ops.camera",
    "vbr_tpu_torch.ops.carve",
    "vbr_tpu_torch.ops.carve_blocked",
    "vbr_tpu_torch.ops.ccl",
    "vbr_tpu_torch.ops.ccl_label",
    "vbr_tpu_torch.ops.color",
    "vbr_tpu_torch.ops.gmm",
    "vbr_tpu_torch.ops.morphology",
    "vbr_tpu_torch.pipelines.background",
    "vbr_tpu_torch.utils.artifacts",
    "vbr_tpu_torch.utils.config",
    "vbr_tpu_torch.utils.device",
    "vbr_tpu_torch.utils.synthetic",
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

