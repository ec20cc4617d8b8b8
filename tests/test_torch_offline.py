"""Port parity: the offline multi-frame carve (K4) and
``VisualHull.process_frames_offline``.

``vbr_tpu``'s counts kernel runs in interpret mode; the port runs K4's
plain version on the CPU.  Everything is integer, so occupancy, colour
indices and colours are compared with zero tolerance: against ``vbr_tpu``,
against the per-frame table carve, and for a frame that overflows the
device component tables against the exact per-frame redo.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import carve_pallas as jcp
from vbr_tpu.pipelines import background as jbackground
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import carve as tcarve
from vbr_tpu_torch.ops import carve_blocked as tcb
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import synthetic as tsyn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W, C = 64, 96, 4
GRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)


@pytest.fixture(scope="module")
def carve_rig():
    """Tables of both packages and F = 5 mask sets: moving spheres with
    speckle, then one all-foreground frame (blocks full in that frame
    only, so the chunk's intersection is not full)."""
    cams_j = jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    cams_t = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    jt = jcp.build_block_tables(cams_j, jconfig.GridConfig(**GRID), (H, W),
                                accelerate=False)
    tt = tcb.build_block_tables(cams_t, tconfig.GridConfig(**GRID), (H, W))
    ptab = tcarve.build_projection_tables(cams_t, tconfig.GridConfig(**GRID),
                                          (H, W))
    rng = np.random.default_rng(21)
    masks = []
    for i in range(4):
        center = np.array([60.0 + 90 * i, -40.0, -650.0])
        m = np.stack([tsyn.sphere_silhouette_mask(cp, center, 520.0, (H, W))
                      for cp in cams_t])
        speckle = rng.random((C, H, W)) < 0.03
        masks.append(np.where(speckle, 255 - m, m).astype(np.uint8))
    masks.append(np.full((C, H, W), 255, np.uint8))
    return jt, tt, ptab, np.stack(masks)


@pytest.mark.parametrize("thr,nf", [(4, 2), (3, 2), (4, 8), (4, 5)])
def test_carve_frames_blocked_matches(carve_rig, thr, nf):
    """F = 5 with ``frames_per_launch`` 2 and 8 pads the last chunk; with
    5 the all-foreground frame shares its launch with carved ones."""
    jt, tt, ptab, masks = carve_rig
    got = tcb.carve_frames_blocked(torch.from_numpy(masks), tt,
                                   views_threshold=thr,
                                   frames_per_launch=nf).numpy()
    assert got.shape == (5, 32**3) and got.dtype == bool
    ref = np.asarray(jcp.carve_frames_blocked(
        jnp.asarray(masks), jt, views_threshold=thr, frames_per_launch=nf,
        interpret=True))
    np.testing.assert_array_equal(got, ref)
    images = torch.zeros((C, H, W, 3), dtype=torch.uint8)
    for f in range(5):
        occ_f, _ = tcarve.carve_from_tables(
            torch.from_numpy(masks[f]), images, ptab.valid, ptab.lin_idx,
            views_threshold=thr)
        np.testing.assert_array_equal(got[f], occ_f.numpy())
    assert 0 < got[0].sum() < got[4].sum()
    assert (got[0] != got[3]).any()


def test_full_in_one_frame_only(carve_rig):
    """A block that is full in one frame of the chunk is full on no
    intersection: it must be carved from the tables, not short-cut."""
    _, tt, _, masks = carve_rig
    chunk = torch.from_numpy(masks[3:5])
    _, full_one = tcb.block_activity(chunk[1], 4, tt.allv, tt.ry, tt.rx)
    _, full_both = tcb.block_activity(chunk.amin(dim=0), 4, tt.allv, tt.ry,
                                      tt.rx)
    assert int(full_one.sum()) > int(full_both.sum())


def test_carve_frames_batched_matches_per_frame(carve_rig):
    _, _, ptab, masks = carve_rig
    rng = np.random.default_rng(3)
    images = torch.from_numpy(
        rng.integers(0, 256, (3, C, H, W, 3), dtype=np.uint8))
    occ, col = tcarve.carve_frames_batched(
        torch.from_numpy(masks[:3]), images, ptab.valid, ptab.lin_idx,
        views_threshold=3, color_camera=2)
    for f in range(3):
        o, c = tcarve.carve_from_tables(
            torch.from_numpy(masks[f]), images[f], ptab.valid, ptab.lin_idx,
            views_threshold=3, color_camera=2)
        assert torch.equal(occ[f], o) and torch.equal(col[f], c)


def test_k4_wrapper_uses_plain_on_cpu_only(carve_rig):
    _, tt, _, masks = carve_rig
    chunk = torch.from_numpy(masks[:2])
    act, _ = tcb.block_activity(chunk.amax(dim=0), 4, tt.allv, tt.ry, tt.rx)
    _, full = tcb.block_activity(chunk.amin(dim=0), 4, tt.allv, tt.ry, tt.rx)
    before = tcb.K4.launches
    got = tcb.carve_frames_kernel(tt.pk, act, full, chunk, views_threshold=4)
    want = tcb.carve_frames_plain(tt.pk, act, full, chunk, views_threshold=4)
    assert torch.equal(got, want) and got.shape == (2, tt.nsuper, tt.nsub, 512)
    assert tcb.K4.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        tcb.carve_frames_kernel(tt.pk.to("meta"), act.to("meta"),
                                full.to("meta"), chunk.to("meta"),
                                views_threshold=4)


# -- the whole offline path, on the rig of tests/test_offline_frames.py ----


@pytest.fixture(scope="module")
def models():
    mp = tuple(dataclasses.replace(p, figure_threshold=40.0,
                                   inner_threshold=8.0)
               for p in jconfig.DEFAULT_MASK_PARAMS[:C])
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        jconfig.GridConfig(**GRID),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    rng = np.random.default_rng(7)
    bg = rng.integers(0, 200, size=(C, 6, H, W, 3), dtype=np.uint8)
    mj.bg_states = [jbackground.train_background_model(
        bg[c], jconfig.MOGParams(history=6)) for c in range(C)]
    mj.mog_params = [jconfig.MOGParams(history=6)] * C
    mt = tvh.VisualHull(tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        tconfig.GridConfig(**GRID),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in mp],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s) for s in mj.bg_states]
    mt.mog_params = [tconfig.MOGParams(history=6)] * C
    base = bg[:, 0].copy()
    frames = []
    for ys, xs in ((slice(14, 44), slice(22, 60)),
                   (slice(18, 48), slice(30, 68)),
                   (slice(8, 50), slice(26, 58))):
        f = base.copy()
        f[:, ys, xs] = 255
        frames.append(f)
    return mj, mt, np.stack(frames)  # F = 3


def test_offline_matches_vbr_tpu(models):
    mj, mt, frames = models
    occ_j, col_j = mj.process_frames_offline(frames, frames_per_launch=2,
                                             interpret=True)
    occ_t, col_t = mt.process_frames_offline(frames, frames_per_launch=2)
    assert occ_t.shape == (3, mt.grid.num_voxels) and occ_t.dtype == bool
    np.testing.assert_array_equal(occ_t, occ_j)
    assert occ_t.any() and not (occ_t[0] == occ_t[1]).all()
    for f in range(3):
        np.testing.assert_array_equal(col_t[f][0], col_j[f][0])
        np.testing.assert_array_equal(col_t[f][1], col_j[f][1])
        occ_f, col_f = mt.process_frame(frames[f])
        np.testing.assert_array_equal(occ_t[f], occ_f.numpy())
        np.testing.assert_array_equal(col_t[f][1],
                                      col_f.numpy()[col_t[f][0]])


def test_offline_no_colors(models):
    _, mt, frames = models
    occ, colors = mt.process_frames_offline(frames[:2], frames_per_launch=2,
                                            with_colors=False)
    assert colors is None and occ.shape[0] == 2


def test_offline_overflow_frame_redone_exactly(models):
    """Frame 1 of 3 overflows the device component tables (more than kf
    isolated components): the chunk's device result is replaced by the
    exact per-frame redo, in both packages alike."""
    mj, mt, frames = models
    frames = frames.copy()
    frames[1][:, ::2, ::2] = 255
    mt._ensure_fast_state()
    mt._ensure_btab()
    _, ovf = tvh._full_step_frames(
        mt._stacked_fz, torch.from_numpy(frames[:2]), mt._btab,
        mask_params=mt.mask_params, use_hsv=True,
        fig_thresholds=mt._fig_thresholds,
        inner_thresholds=mt._inner_thresholds, views_threshold=4)
    assert ovf.shape == (2, C)
    assert ovf[1].any() and not ovf[0].any()
    occ_t, col_t = mt.process_frames_offline(frames, frames_per_launch=2)
    occ_j, col_j = mj.process_frames_offline(frames, frames_per_launch=2,
                                             interpret=True)
    np.testing.assert_array_equal(occ_t, occ_j)
    np.testing.assert_array_equal(occ_t[1],
                                  mt.process_frame(frames[1])[0].numpy())
    for f in range(3):
        np.testing.assert_array_equal(col_t[f][1], col_j[f][1])


def test_offline_rejects_non_divisible_grid(models):
    _, mt, _ = models
    m2 = tvh.VisualHull(mt.cameras, tconfig.GridConfig(nx=12, ny=12, nz=12),
                        mt.rig, mt.mask_params, device="cpu")
    m2.bg_states, m2.mog_params = mt.bg_states, mt.mog_params
    with pytest.raises(ValueError, match="8-divisible"):
        m2.process_frames_offline(np.zeros((1, C, H, W, 3), np.uint8))
