"""CPU rehearsal of ``chip_smoke.py``'s phase 24 (the manual corner session
and the reports), at a small size: on the CPU the "card" side is the CPU
as well, so this runs every check of the phase and its bookkeeping, not
the card's parity.  Its inputs are made here as the whole script makes
them in phases 16, 19 and 20: boards rendered at cam1's real poses, the
discard views, three background models' masks and a marching-cubes
mesh."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

HW = (244, 322)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def phase_inputs():
    from vbr_tpu_torch.ops import gmm
    from vbr_tpu_torch.ops import marching_cubes as mc
    from vbr_tpu_torch.pipelines import calibration as calib

    cpu = torch.device("cpu")
    K, dist, rvecs, tvecs = cs.calib_truth(1, HW, views=3)
    frames = cs.render_boards(torch, cpu, K, dist, rvecs, tvecs, HW)
    board = (K, dist, rvecs, tvecs, frames)
    # the discard views as phase 19 makes them: true corners plus noise,
    # one view corrupted
    K5, dist5, rv5, tv5 = cs.calib_truth(1, HW, views=6)
    rng = np.random.default_rng(cs.SEED)
    pts = [t + rng.normal(0, cs.CALIB_NOISE_PX, t.shape)
           for t in cs.true_corners(K5, dist5, rv5, tv5)]
    pts[2] = pts[2] + rng.normal(0, 3.0, pts[2].shape)
    out = calib.discard_bad_image_points(pts, HW[::-1], cs.CALIB_PATTERN,
                                         cs.CALIB_SQUARE, device=cpu)
    discard = (pts, out[0], HW[::-1])
    # KNN, MOG2 and a MOG stand-in on two cameras' seeded backgrounds
    seqs = [cs.background_sequence(rng, rng.integers(40, 200, (48, 64, 3)),
                                   12) for _ in range(2)]
    frame = np.stack([s[-1] for s in seqs]).copy()
    frame[:, 10:30, 20:40] = 255 - frame[:, 10:30, 20:40]
    masks = {
        "KNN": np.stack([gmm.extract_mask_knn(gmm.train_knn(
            s, device=cpu), f).numpy() for s, f in zip(seqs, frame)]),
        "MOG": (np.abs(frame.astype(int) - seqs[0][0]).sum(-1) > 60)
        .astype(np.uint8) * 255,
        "MOG2": np.stack([gmm.extract_mask_mog2(gmm.train_mog2(
            s, device=cpu), f).numpy() for s, f in zip(seqs, frame)])}
    n = 24
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    vol = ((g - [11, 12, 10]) ** 2 / np.array([60.0, 30.0, 80.0])).sum(-1) < 1
    tris = mc.extract_mesh(vol, np.array([-400.0, -300.0, 0.0]),
                           np.array([20.0, 25.0, 30.0]), device="cpu")[0]
    return board, discard, masks, tris


def test_phase_24_runs_on_cpu(phase_inputs, tmp_path):
    board, discard, masks, tris = phase_inputs
    rep = cs.reports_phase(torch, torch.device("cpu"), board, discard,
                           masks, tris, build_root=str(tmp_path))
    assert len(rep["session"]["views"]) == cs.SESSION_VIEWS
    assert rep["session"]["max_diff_px"] == 0.0
    assert rep["session"]["err_vs_truth_px"]["median"] < 0.5
    assert rep["intrinsics"]["runs"] == ["all views", "after discard"]
    assert rep["intrinsics"]["byte_equal"]
    assert rep["mesh"]["triangles"] == len(tris) and rep["mesh"][
        "covered_px"] > 10_000
    for name in ("background_models_mask_comparisons.png",
                 "intrinsic_params_card.png", "marching_cubes.png"):
        assert (tmp_path / "reports" / name).exists()
