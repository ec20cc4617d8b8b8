"""The benchmark's work counts against ``chip_smoke.py``'s ``k1_work`` and
``k4_work`` on a small rig: the same arithmetic where both classify the
8³ blocks alike, and the benchmark's own classification (from the masks
and projections) never counts a block that the program's flags leave
out, so its count is never above the launch's."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from benchmark import reference, roofline

chip_smoke = pytest.importorskip("chip_smoke")


def _parse(text):
    m = re.search(r"\((?:bytes|operations): (\d+) B, (\d+) ops\)", text)
    return int(m.group(1)), int(m.group(2))


@pytest.fixture(scope="module")
def rig():
    from vbr_tpu_torch.ops import carve_blocked as cb
    from vbr_tpu_torch.utils.config import DEFAULT_MASK_PARAMS, GridConfig

    r = chip_smoke.seeded_rig(torch, (120, 160), 120.0)
    grid = GridConfig(nx=32, ny=32, nz=32)
    mp = [dataclasses.replace(p, figure_threshold=200, inner_threshold=8)
          for p in DEFAULT_MASK_PARAMS]
    model = chip_smoke.seeded_model(r, "cpu", grid, mp)
    cams = [{"K": c.K.tolist(), "dist": c.dist.tolist(),
             "rvec": c.rvec.tolist(), "tvec": c.tvec.tolist()}
            for c in model.cameras]
    gd = {f: getattr(grid, f) for f in ("nx", "ny", "nz", "x_min", "x_max",
                                        "y_min", "y_max", "z_min", "z_max")}
    proj = reference.Projections(cams, gd, r.image_hw, "cpu")
    blocks = roofline.Blocks(gd, "cpu")
    btab = model._btab
    # each sub-block of the program's tables is one 8³ block of the grid
    sub_block = blocks.ids[torch.from_numpy(
        btab.perm.reshape(-1, cb.BV)[:, 0])]
    return cb, r, model, proj, blocks, btab, sub_block


def _mapped(blocks, sub_block, flags):
    out = torch.zeros(blocks.n, dtype=torch.bool)
    out[sub_block] = flags.bool()
    return out


def test_k1_counts_as_chip_smoke(rig):
    cb, r, model, proj, blocks, btab, sub_block = rig
    masks = model.masks(r.frame0)
    active, full = cb.block_activity(masks, 4, btab.allv, btab.ry, btab.rx)
    occ_b, _ = cb.carve_blocked_kernel(btab.pk, btab.lcc, active, full,
                                       masks, torch.from_numpy(
                                           r.frame0[btab.color_camera]),
                                       color_camera=btab.color_camera,
                                       views_threshold=4)
    want = _parse(chip_smoke.k1_work(torch, cb, btab, active, full, masks,
                                     occ_b).text)
    act, ful = active.bool(), full.bool()
    flags = (_mapped(blocks, sub_block, act & ~ful),
             _mapped(blocks, sub_block, ful))
    occ, _ = reference.carve(masks > 0, torch.from_numpy(r.frame0), proj, 4,
                             btab.color_camera)
    assert int(occ.sum()) == int(occ_b.sum()) > 0
    got = roofline.k1_work(proj, blocks, masks > 0, occ, 4,
                           btab.color_camera, flags=flags)
    nblk = btab.nsuper * btab.nsub
    assert got == (want[0] - 8 * nblk, want[1])
    computed, full_own = roofline.classify(proj, blocks, masks > 0, 4)
    assert not bool((computed & ~_mapped(blocks, sub_block, act)).any())
    assert not bool((flags[1] & ~full_own).any())
    assert roofline.k1_work(proj, blocks, masks > 0, occ, 4,
                            btab.color_camera)[0] <= got[0]


def test_k4_counts_as_chip_smoke(rig):
    cb, r, model, proj, blocks, btab, sub_block = rig
    masks, active, full = chip_smoke.k4_chunk(torch, cb, model, r.seq)
    occ = cb.carve_frames_kernel(btab.pk, active, full, masks,
                                 views_threshold=4)
    want = _parse(chip_smoke.k4_work(torch, cb, btab, active, full, masks,
                                     occ).text)
    act, ful = active.bool(), full.bool()
    flags = (_mapped(blocks, sub_block, act & ~ful),
             _mapped(blocks, sub_block, ful))
    got = roofline.k4_work(proj, blocks, masks > 0, 4, flags=flags)
    nblk = btab.nsuper * btab.nsub
    assert got == (want[0] - 8 * nblk, want[1])
    assert roofline.k4_work(proj, blocks, masks > 0, 4)[0] <= got[0]


def test_k2_counts_one_byte_in_and_a_label_out_per_pixel():
    assert roofline.k2_bytes(4, (486, 644)) == 4 * (486 * 644 * 5 + 4)
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)
    assert np.isclose(roofline.least_s(3.35e12, 134e12), 2.0)
