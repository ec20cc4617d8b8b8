"""``chip_smoke.py``: refuses without a card or without the repository,
and its phases run end to end on the CPU at a small rig size (where every
"kernel" is its plain version, so this checks the script, not the card)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_refuses_without_a_card():
    res = _run(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_phases_run_on_cpu_small_rig(capsys):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS, GridConfig

    mp = [dataclasses.replace(p, figure_threshold=200.0, inner_threshold=8.0)
          for p in DEFAULT_MASK_PARAMS]
    report = chip_smoke.run("cpu", (120, 160), GridConfig(nx=32, ny=32,
                                                          nz=32),
                            focal=120.0, mask_params=mp, train_frames=3,
                            k3_frames=2)
    names = [k["name"] for k in report["kernels"]]
    assert names == ["K1 carve_blocked", "K2 ccl_combined", "K3 mog_train",
                     "K4 carve_frames", "K5 ccl_label"]
    for k in report["kernels"]:
        assert k["max_abs_err"] == 0 and k["bound_ms"] > 0
        assert set(k) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms"}
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    out = capsys.readouterr().out
    assert "overflow bits set" in out and "FAILED" not in out
    for phase in ("[9] K3", "[10] train_background", "[11] K4",
                  "[12] process_frames_offline", "[13] K5"):
        assert phase in out
    assert "bit-equal to the plain version on the CPU" in out
    assert "equal to process_frame_fast" in out
    assert report["offline"]["frames"] == 16
