"""``correct`` comes out false when the timed path is broken underneath a
run (the harness's look for a card skipped, everything else as a run
does it), for each fault a cell can have: a step that hands back its first
result (state unchanged), half of each batch of camera images left out
(the carve decided by the rest), and one voxel of an answer altered where
it is produced.  One card holds each cell: there is no exchange between
cards to leave out."""

import pytest
import torch

from benchmark import run, spec
from benchmark.tests import small


def _stale(step):
    first = {}

    def wrapped(*a, **k):
        if "out" not in first:
            first["out"] = step(*a, **k)
        return first["out"]
    return wrapped


def _flip(step):
    def wrapped(*a, **k):
        occ, *rest = step(*a, **k)
        occ = occ.clone()
        flat = occ.reshape(-1, occ.shape[-1]) if occ.dim() > 1 else occ[None]
        for row in flat:  # one voxel of every frame
            i = int(torch.nonzero(row)[0]) if bool(row.any()) else 0
            row[i] = ~row[i]
        return (occ, *rest)
    return wrapped


def _half(finalize):
    def wrapped(cleaned, mask_params):
        m = finalize(cleaned, mask_params).clone()
        m[m.shape[0] // 2:] = 255
        return m
    return wrapped


STEP = {"open_loop": "_full_step", "closed_loop_video": "_full_step_frames"}
CELLS = {w["name"]: STEP[spec.traffic(run.ROOT, w["traffic"])["loop"]]
         for w in small.bench()["workloads"]}


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("fault", ["stale", "half", "flip"])
def test_a_broken_step_is_not_correct(cell, fault, rig, monkeypatch):
    from vbr_tpu_torch.models import visual_hull
    from vbr_tpu_torch.pipelines import background

    if fault == "half":
        monkeypatch.setattr(background, "finalize_masks_batched",
                            _half(background.finalize_masks_batched))
    else:
        wrap = _stale if fault == "stale" else _flip
        monkeypatch.setattr(visual_hull, CELLS[cell],
                            wrap(getattr(visual_hull, CELLS[cell])))
    result = rig.execute(cell, seconds=0.6)
    assert result["correct"] is False, result["check"]


def test_a_sound_step_is_correct(rig):
    assert rig.execute("rig128-offline")["correct"] is True


def test_the_control_fails_the_check_at_the_rigs_size(tmp_path):
    """The reference in the precision below the configuration's (MOG in
    bfloat16, projections in float32), at the rig's 486×644 images and
    128³ grid with 3 background frames: it fails ``correct``."""
    from benchmark import check, control

    r = small.Rig(tmp_path, image_hw=None, grid_n=None, background_frames=3,
                  traffic={"video_frames": 60, "check_frames": 6})
    numbers = control.control_numbers(r.bench, "rig128-live", 21, 1.0,
                                      "cpu", r.root)
    _, within = check.judged(numbers)
    assert not within, numbers
