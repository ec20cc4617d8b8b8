"""The plain reference against the port's CPU path, stage by stage, on the
small rig: the masks of every camera and the occupancy and colours of the
step (frame 6 carries a burst, so the program redoes it), and a hull that
is not empty."""

import numpy as np
import pytest
import torch

from benchmark import check, program, rigdata, spec


@pytest.fixture(scope="module")
def sides(rig):
    cfg = spec.config(rig.root, rig.bench, "rig128x4")
    traffic = spec.traffic(rig.root, "live46")
    inputs = rigdata.make(rig.root, cfg, traffic, 31, torch.device("cpu"))
    model = program.build(cfg, inputs, "cpu")
    redos = program.count_redos(model)
    ref = check.Reference(cfg, inputs, "cpu")
    return inputs, model, ref, redos


@pytest.mark.parametrize("j", [0, 6, 9, 23])
def test_the_reference_masks_equal_the_port(sides, j):
    inputs, model, ref, _ = sides
    got = model.masks(inputs.video[j]) > 0
    want = ref.masks(j)
    assert torch.equal(got, want)
    share = want.float().mean(dim=(1, 2))
    assert bool((share > 0.01).all() and (share < 0.2).all())


@pytest.mark.parametrize("j", [0, 6, 9, 23])
def test_the_reference_carve_equals_the_port(sides, j):
    inputs, model, ref, redos = sides
    before = redos["redos"]
    occ, col = model.process_frame_fast(inputs.video[j])
    assert redos["redos"] - before == (j == 6)
    r_occ, r_col = ref.outputs(j)
    assert int(r_occ.sum()) > 0
    assert torch.equal(occ, r_occ) and torch.equal(col, r_col)


def test_the_reference_models_decide_as_the_port(sides):
    """The trained models' decision slots B per pixel equal the port's
    compressed state's."""
    inputs, model, ref, _ = sides
    model._ensure_fast_state()
    from benchmark import reference

    for c, (w, _, _) in enumerate(ref.models):
        B = reference.decision_slots(w, ref.mog["bg_ratio"])
        got = model._stacked_fz.bcount[c].reshape(-1)
        assert np.array_equal(B.numpy(), got.numpy())


def test_the_inputs_follow_the_seed(rig):
    cfg = spec.config(rig.root, rig.bench, "rig128x4")
    traffic = dict(spec.traffic(rig.root, "live46"), video_frames=8)
    make = [rigdata.make(rig.root, cfg, traffic, s, torch.device("cpu"))
            for s in (2**31 + 5, 2**31 + 5, 6)]
    assert np.array_equal(make[0].video, make[1].video)
    assert np.array_equal(make[0].background, make[1].background)
    assert not np.array_equal(make[0].background, make[2].background)
