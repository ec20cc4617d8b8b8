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
                            k3_frames=2, label_large_hw=(16, 256),
                            label_cap=16)
    names = [k["name"] for k in report["kernels"]]
    assert names == ["K1 carve_blocked", "K2 ccl_combined", "K3 mog_train",
                     "K4 carve_frames", "K5 ccl_label"]
    for k in report["kernels"]:
        assert k["max_abs_err"] == 0 and k["bound_ms"] > 0
        # the labelling kernels also report the route their launcher took
        more = {"kernel_route"} if k["name"][:2] in ("K2", "K5") else set()
        assert set(k) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms"} | more
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    out = capsys.readouterr().out
    assert "overflow bits set" in out and "FAILED" not in out
    for phase in ("[9] K3", "[10] train_background", "[11] K4",
                  "[12] process_frames_offline", "[13] K5"):
        assert phase in out
    assert "bit-equal to the plain version on the CPU" in out
    for name in ("K2", "K5"):
        assert f"{name}: the cap cut the corridor short at 16" in out
        assert f"{name}: iteration counts differ within the batch" in out
        assert f"{name}: the cap cut the upright corridor short too" in out
        for what in ("checkerboard", "band seams", "too large for a cluster",
                     "small", "dense random image", "crossing column sweeps"):
            assert f"{name} {what}" in out
    assert "equal to process_frame_fast" in out
    assert report["offline"]["frames"] == 16


def test_crossing_sweeps_meet_inside_every_band():
    """The image that holds the cluster route's two column sweeps apart:
    after one iteration the block holds its own label and every spine its
    own, lower from band to band; the second iteration carries each
    band's label down into the next while the last band's goes up."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from vbr_tpu_torch.ops import ccl_label

    H, W, bands = 488, 768, 8
    R = H // bands
    img = torch.from_numpy(chip_smoke.crossing_sweeps(H, W, bands)[None])
    assert not bool(img[0, :, :32].any())  # no carry in a warp's first columns
    for plain in (ccl_label.label_components_batched_plain,
                  ccl_label.label_components_combined_plain):
        one = plain(img, max_iters=1)[0][0]
        two = plain(img, max_iters=2)[0][0]
        spines = [int(one[(b + 1) * R - 1, 160 + 4 * b]) for b in range(bands)]
        assert spines == sorted(spines, reverse=True) and len(set(spines)) == 8
        block = one[2 * bands + 4:, 32:128]
        assert int(block.min()) == int(block.max()) > spines[0]
        assert bool((two[2 * bands + 4:, 32:128] == spines[-1]).all())
