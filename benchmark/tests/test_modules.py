"""The module scan: JAX and the JAX package by whole top-level names, and
what the harness and its reference load."""

import subprocess
import sys

import pytest

from benchmark import run


@pytest.mark.parametrize("names, found", [
    (["vbr_tpu_torch", "vbr_tpu_torch.ops.carve", "numpy", "torch"], []),
    (["vbr_tpu", "vbr_tpu_torch"], ["vbr_tpu"]),
    (["vbr_tpu.ops.carve"], ["vbr_tpu"]),
    (["jaxlib.xla_client", "jax._src", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "vbr_tpu2"], []),
])
def test_the_scan_compares_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = (
        "import glob, os, sys\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import run, spec, check, control, sweep\n"
        "from benchmark.loops import open_loop, closed_loop_video\n"
        "from benchmark import program\n"
        "from vbr_tpu_torch.models.visual_hull import VisualHull\n"
        "for p in glob.glob('benchmark/metrics/*.py'):\n"
        "    spec.reader(os.path.basename(p)[:-3])\n"
        "print(*run.forbidden_modules(list(sys.modules)) or ['none'])\n")
    assert _loaded(code) == ["none"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "from benchmark import reference, check, rigdata, roofline\n"
            "print(*sorted({m.split('.')[0] for m in sys.modules}"
            " & {'vbr_tpu', 'vbr_tpu_torch', 'jax'}) or ['none'])\n")
    assert _loaded(code) == ["none"]
