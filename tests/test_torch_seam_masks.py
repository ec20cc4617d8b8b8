"""Port parity of the seam's mask stage and of the table step: the one-image
cleanup in plain torch ops (``ccl.label_components`` / ``component_areas``
/ ``clean_mask``), ``background.extract_foreground_mask`` and
``VisualHull.masks`` on all three cleanup routes, and
``process_frame_fast`` on a grid that is not divisible by 8·sup, against
``vbr_tpu`` on the same seeded inputs.  Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import ccl as jccl
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.pipelines import background as jbg
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import ccl as tccl
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.pipelines import background as tbg
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


ROUTES = ["device", "host", "device-xla"]


def _noisy_mask(rng, H=96, W=128):
    """A figure + speckle noise + holes, like a raw GMM mask (the shapes
    of the JAX package's labelling tests)."""
    m = np.zeros((H, W), np.uint8)
    m[20:80, 30:90] = 255  # figure
    m[40:52, 50:62] = 0  # big hole
    m[28:31, 40:43] = 0  # small hole
    for _ in range(40):  # speckles
        y, x = rng.integers(0, H), rng.integers(0, W)
        m[y:y + 2, x:x + 2] = 255
    return m


def _images():
    rng = np.random.default_rng(0)
    noisy = _noisy_mask(rng) > 0
    return {"noisy figure": noisy, "noisy background": ~noisy,
            "random 37x53": rng.random((37, 53)) < 0.55}


IMAGES = _images()


@pytest.mark.parametrize("max_iters", [2, 64], ids=["cap 2", "cap 64"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_label_components_and_areas(name, max_iters):
    fg = IMAGES[name]
    got = tccl.label_components(torch.from_numpy(fg), max_iters)
    want = np.asarray(jccl.label_components(jnp.asarray(fg), max_iters))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tccl.component_areas(got).numpy(),
        np.asarray(jccl.component_areas(jnp.asarray(want))))


def test_the_cap_stops_the_labelling_early():
    fg = IMAGES["random 37x53"]
    capped = tccl.label_components(torch.from_numpy(fg), 2)
    assert not torch.equal(capped, tccl.label_components(
        torch.from_numpy(fg), 64))


@pytest.mark.parametrize("thresholds", [(200.0, 20.0), (40.0, 5.0),
                                        (5000.0, 115.0)])
@pytest.mark.parametrize("name", list(IMAGES))
def test_clean_mask(name, thresholds):
    raw = np.where(IMAGES[name], 255, 0).astype(np.uint8)
    got = tccl.clean_mask(torch.from_numpy(raw), *thresholds)
    want = np.asarray(jccl.clean_mask(jnp.asarray(raw), *thresholds))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tccl.clean_mask_host(raw, *thresholds))


# -- a small rig with seeded background models ----------------------------

H, W, C, K = 64, 96, 4, 50
GRID_ODD = dict(nx=20, ny=16, nz=16, x_min=-900, x_max=1100, y_min=-1050,
                y_max=950, z_min=-1700, z_max=300)
FG_BGR = np.array([30, 220, 250], np.uint8)
MASK_PARAMS = [dataclasses.replace(p, figure_threshold=40.0,
                                   inner_threshold=8.0)
               for p in jconfig.DEFAULT_MASK_PARAMS]


def _frame(rng, bg, center, speckle=20, holes=6):
    cams = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    fr = bg.copy()
    for c, cp in enumerate(cams):
        sil = tsyn.sphere_silhouette_mask(cp, np.asarray(center), 520.0,
                                          (H, W)) > 0
        fr[c][sil] = FG_BGR
        ys, xs = rng.integers(0, H, speckle), rng.integers(0, W, speckle)
        fr[c, ys, xs] = FG_BGR
        ys, xs = np.nonzero(sil)
        for i in rng.integers(0, len(ys), holes):
            fr[c, ys[i]:ys[i] + 2, xs[i]:xs[i] + 2] = bg[c, ys[i]:ys[i] + 2,
                                                        xs[i]:xs[i] + 2]
    return fr


@pytest.fixture(scope="module")
def rig():
    """Both packages' models of one small rig on a 20x16x16 grid, the same
    background models, a frame and a frame that overflows the device
    component tables."""
    rng = np.random.default_rng(5)
    bg = rng.integers(40, 200, size=(C, H, W, 3), dtype=np.uint8)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    states = []
    for c in range(C):
        w = np.zeros((H, W, K), np.float32)
        w[..., :3] = rng.dirichlet([6.0, 3.0, 1.0], size=(H, W))
        mean = np.zeros((H, W, K, 3), np.float32)
        mean[..., :3, :] = (bg_hsv[c][:, :, None, :].astype(np.float32)
                            + rng.normal(0, 3, (H, W, 3, 3)))
        var = np.zeros((H, W, K), np.float32)
        var[..., :3] = rng.uniform(150.0, 600.0, (H, W, 3))
        states.append(jgmm.MOGState(weight=jnp.asarray(w),
                                    mean=jnp.asarray(mean),
                                    var=jnp.asarray(var),
                                    nframes=jnp.int32(40)))
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        jconfig.GridConfig(**GRID_ODD),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=MASK_PARAMS)
    mj.bg_states = states
    mj.mog_params = [jconfig.MOGParams()] * C
    mt = tvh.VisualHull(tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        tconfig.GridConfig(**GRID_ODD),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in MASK_PARAMS],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s, "cpu") for s in states]
    mt.mog_params = [tconfig.MOGParams()] * C
    frame = _frame(rng, bg, (60.0, -40.0, -650.0))
    over = _frame(rng, bg, (90.0, -40.0, -650.0), speckle=0)
    over[:, ::3, ::3] = FG_BGR  # more isolated components than kf
    return mj, mt, {"frame": frame, "overflowing frame": over}


@pytest.mark.parametrize("which", ["frame", "overflowing frame"])
@pytest.mark.parametrize("route", ROUTES)
def test_extract_foreground_mask(rig, route, which):
    mj, mt, frames = rig
    frame = frames[which]
    for c in (0, 2):  # camera 3 closes before the cleanup
        got = tbg.extract_foreground_mask(
            mt.bg_states[c], frame[c], mt.mask_params[c], mt.mog_params[c],
            ccl_backend=route)
        want = jbg.extract_foreground_mask(
            mj.bg_states[c], frame[c], mj.mask_params[c], mj.mog_params[c],
            ccl_backend=route)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert which != "frame" or 0 < int((got > 0).sum()) < H * W


def test_the_overflowing_frame_overflows(rig):
    """What the device route's exact host redo needs: the frame's raw
    masks overflow the device component tables (camera 1, no
    pre-morphology)."""
    from vbr_tpu_torch.ops import gmm as tgmm

    _, mt, frames = rig
    raw = tgmm.extract_mask(mt.bg_states[0], frames["overflowing frame"][0],
                            mt.mog_params[0])
    _, ovf = tccl.clean_masks_batched(raw[None], (40.0,), (8.0,))
    assert bool(ovf[0])


def test_extract_foreground_mask_refuses_an_unknown_route(rig):
    _, mt, frames = rig
    with pytest.raises(ValueError, match="ccl_backend"):
        tbg.extract_foreground_mask(mt.bg_states[0], frames["frame"][0],
                                    ccl_backend="gpu")


@pytest.mark.parametrize("which", ["frame", "overflowing frame"])
@pytest.mark.parametrize("route", ROUTES)
def test_masks_routes(rig, route, which):
    mj, mt, frames = rig
    got = mt.masks(frames[which], ccl_backend=route)
    np.testing.assert_array_equal(got.numpy(),
                                  mj.masks(frames[which], ccl_backend=route))
    np.testing.assert_array_equal(got.numpy(), mt.masks(frames[which]).numpy())


@pytest.mark.parametrize("which", ["frame", "overflowing frame"])
def test_tables_step_on_a_grid_not_divisible(rig, which):
    """20 is not divisible by 8·sup = 16: no blocked tables, so both
    packages take the table step (with the exact host redo for the
    overflowing frame) and return canonical order whatever the layout."""
    mj, mt, frames = rig
    assert mt._ensure_btab() is None
    occ_j, col_j = mj.process_frame_fast(frames[which])
    for layout in ("canonical", "blocked"):
        occ_t, col_t = mt.process_frame_fast(frames[which], layout=layout)
        assert occ_t.shape == (20 * 16 * 16,)
        np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
        np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    occ_p, col_p = mt.process_frame(frames[which])
    np.testing.assert_array_equal(occ_p.numpy(), np.asarray(occ_j))
    assert 20 < int(occ_t.sum()) < occ_t.numel()
    with pytest.raises(ValueError, match="divisible"):
        mt.process_frame_fast(frames[which], carve_kernel="blocked")


def test_table_step_on_request_equals_the_blocked_carve(rig):
    """On a divisible grid ``carve_kernel="tables"`` gives the blocked
    carve's occupancy, and its colours at occupied voxels."""
    _, mt, frames = rig
    m2 = tvh.VisualHull(mt.cameras, tconfig.GridConfig(nx=16, ny=16, nz=16),
                        mt.rig, mt.mask_params, device="cpu")
    m2.bg_states, m2.mog_params = mt.bg_states, mt.mog_params
    occ_b, col_b = m2.process_frame_fast(frames["frame"])
    occ_t, col_t = m2.process_frame_fast(frames["frame"],
                                         carve_kernel="tables")
    assert torch.equal(occ_b, occ_t) and int(occ_t.sum()) > 0
    assert torch.equal(col_b[occ_b], col_t[occ_t])
    with pytest.raises(ValueError, match="carve_kernel"):
        m2.process_frame_fast(frames["frame"], carve_kernel="pallas")
