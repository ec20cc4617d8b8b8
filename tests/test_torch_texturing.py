"""Port parity of the textured hull (``vbr_tpu_torch/ops/texturing.py`` and
``VisualHull.textured_frame``) against ``vbr_tpu`` on the synthetic rig.
Every comparison is exact: the tables are the same f64 host arithmetic,
the depth maps a scatter-min, and both packages' ``argmin`` return the
first of equal depths."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import carve as jcarve
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.ops import texturing as jtex
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import texturing as ttex
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


GRID = dict(nx=24, ny=24, nz=24, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)
HW = (486, 644)


@pytest.fixture(scope="module")
def scene():
    """The synthetic rig with each camera's frame one distinct colour, the
    tables of both packages and the carved occupancy."""
    cams_j, masks, frames = jsyn.synthetic_rig()
    for c in range(4):
        frames[c] = 0
        frames[c, :, :, c % 3] = 200 + c * 10
    grid_j = jconfig.GridConfig(**GRID)
    ptab = jcarve.build_projection_tables(cams_j, grid_j, HW)
    occ, _ = jcarve.carve_from_tables(jnp.asarray(masks),
                                      jnp.asarray(frames), ptab.valid,
                                      ptab.lin_idx)
    tj = jtex.build_texturing_tables(cams_j, grid_j, HW)
    tt = ttex.build_texturing_tables(tsyn.synthetic_rig()[0],
                                     tconfig.GridConfig(**GRID), HW,
                                     device="cpu")
    return frames, np.array(occ), tj, tt


def test_tables_match(scene):
    _, _, tj, tt = scene
    assert tt.image_hw == tj.image_hw
    for name in ("valid", "lin_idx", "depth"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tj, name)))


def test_tables_default_to_the_card():
    """Without a card the default device raises instead of building the
    tables on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttex.build_texturing_tables(tsyn.synthetic_rig()[0],
                                    tconfig.GridConfig(**GRID), HW)


def test_depth_maps_match(scene):
    _, occ, tj, tt = scene
    want = np.asarray(jtex.depth_maps(jnp.asarray(occ), tj.valid, tj.lin_idx,
                                      tj.depth, image_hw=HW))
    got = ttex.depth_maps(torch.from_numpy(occ), tt.valid, tt.lin_idx,
                          tt.depth, image_hw=HW).numpy()
    assert (got < 1e30).any(axis=1).all()  # every camera sees the sphere
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tie", [False, True])
def test_textured_colors_match(scene, tie):
    """Colours and the chosen camera equal; with ``tie`` cameras 1-3 get
    camera 0's depths, so every voxel that camera 0 and another camera
    both see is a tie the first minimum must break."""
    frames, occ, tj, tt = scene
    depth_j, depth_t = tj.depth, tt.depth
    if tie:
        depth_t = depth_t[:1].expand(4, -1).contiguous()
        depth_j = jnp.asarray(depth_t.numpy())
    want = jtex.textured_colors(jnp.asarray(occ), jnp.asarray(frames),
                                tj.valid, tj.lin_idx, depth_j, image_hw=HW)
    got = ttex.textured_colors(torch.from_numpy(occ),
                               torch.from_numpy(frames), tt.valid, tt.lin_idx,
                               depth_t, image_hw=HW)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if tie:  # ties: hull voxels that cameras 0 and 1 both project into
        assert (tt.valid[0] & tt.valid[1]).numpy()[occ].any()
    else:
        assert set(np.unique(got[1].numpy()[occ]).tolist()) == {0, 1, 2, 3}


def test_textured_frame_matches():
    """``VisualHull.textured_frame`` in both packages on a seeded model and
    a painted frame: occupancy, colours and the chosen camera equal."""
    H, W, C, K = 64, 96, 4, 50
    rng = np.random.default_rng(2)
    bg = rng.integers(40, 200, size=(C, H, W, 3), dtype=np.uint8)
    states = []
    for _ in range(C):
        w = np.zeros((H, W, K), np.float32)
        w[..., 0] = 1.0
        mean = np.zeros((H, W, K, 3), np.float32)
        var = np.zeros((H, W, K), np.float32)
        var[..., 0] = 100.0
        states.append(jgmm.MOGState(weight=jnp.asarray(w),
                                    mean=jnp.asarray(mean),
                                    var=jnp.asarray(var),
                                    nframes=jnp.int32(40)))
    cams = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    frame = np.zeros((C, H, W, 3), np.uint8)
    for c, cp in enumerate(cams):  # the sphere bright on black
        sil = tsyn.sphere_silhouette_mask(cp, np.array([60.0, -40.0, -650.0]),
                                          520.0, (H, W)) > 0
        frame[c][sil] = bg[c][sil] | 128
    mp = [dataclasses.replace(p, figure_threshold=40.0, inner_threshold=8.0)
          for p in jconfig.DEFAULT_MASK_PARAMS]
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        jconfig.GridConfig(**GRID),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    mj.bg_states, mj.mog_params = states, [jconfig.MOGParams()] * C
    mt = tvh.VisualHull(cams, tconfig.GridConfig(**GRID),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in mp],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s, "cpu") for s in states]
    mt.mog_params = [tconfig.MOGParams()] * C
    got = mt.textured_frame(frame)
    # the reference takes the port's masks (held equal to its own by
    # tests/test_torch_seam_masks.py), which spares it a compile
    masks = mt.masks(frame).numpy()
    want = mj.textured_frame(frame, masks)
    assert int(got[0].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(mt.textured_frame(frame, masks), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
