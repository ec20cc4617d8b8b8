"""Port parity of the whole per-frame step (``VisualHull``).

The port's ``process_frame_fast`` on the CPU equals ``vbr_tpu``'s single
program ``_full_step_pallas(..., interpret=True)`` bit for bit, in both
layouts; a frame that overflows the device component tables is redone
exactly through the host cleanup in both packages; background models
saved by one package load into the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vbr_tpu.models import visual_hull as jvh
from vbr_tpu.ops import carve_pallas as jcp
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.utils import config as jconfig
from vbr_tpu.utils import synthetic as jsyn
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import color as tcolor
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


H, W, C, K = 64, 96, 4, 50
GRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)
FG_BGR = np.array([30, 220, 250], np.uint8)


def _mog(rng, bg_hsv, n_slots=3):
    w = np.zeros((H, W, K), np.float32)
    w[..., :n_slots] = rng.dirichlet([6.0, 3.0, 1.0][:n_slots], size=(H, W))
    mean = np.zeros((H, W, K, 3), np.float32)
    mean[..., :n_slots, :] = (bg_hsv[:, :, None, :].astype(np.float32)
                              + rng.normal(0, 3, (H, W, n_slots, 3)))
    var = np.zeros((H, W, K), np.float32)
    var[..., :n_slots] = rng.uniform(150.0, 600.0, (H, W, n_slots))
    return w, mean, var


def _frame(rng, bg, center, speckle=20, holes=6):
    """Background + painted sphere silhouettes + speckle + holes."""
    cams = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)
    fr = bg.copy()
    for c, cp in enumerate(cams):
        sil = tsyn.sphere_silhouette_mask(cp, np.asarray(center), 520.0,
                                          (H, W)) > 0
        fr[c][sil] = FG_BGR
        for _ in range(speckle):
            y, x = rng.integers(0, H), rng.integers(0, W)
            fr[c, y, x] = FG_BGR
        ys, xs = np.nonzero(sil)
        for i in rng.integers(0, len(ys), holes):
            fr[c, ys[i]:ys[i] + 2, xs[i]:xs[i] + 2] = bg[c, ys[i]:ys[i] + 2,
                                                        xs[i]:xs[i] + 2]
    return fr


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(5)
    bg = rng.integers(40, 200, size=(C, H, W, 3), dtype=np.uint8)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    mogs = [_mog(rng, bg_hsv[c]) for c in range(C)]
    mp = [dataclasses.replace(p, figure_threshold=40.0, inner_threshold=8.0)
          for p in jconfig.DEFAULT_MASK_PARAMS]
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        jconfig.GridConfig(**GRID),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    mj.bg_states = [jgmm.MOGState(weight=jnp.asarray(w), mean=jnp.asarray(m),
                                  var=jnp.asarray(v), nframes=jnp.int32(40))
                    for w, m, v in mogs]
    mj.mog_params = [jconfig.MOGParams()] * C
    mt = tvh.VisualHull(tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        tconfig.GridConfig(**GRID),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in mp],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s, "cpu") for s in mj.bg_states]
    mt.mog_params = [tconfig.MOGParams()] * C
    frames = [_frame(rng, bg, (60.0 + 40 * i, -40.0, -650.0))
              for i in range(3)]
    return mj, mt, bg, frames


def _jax_step(mj, frame, layout):
    mj._ensure_fast_state()
    mj._ensure_btab()
    b = mj._btab
    return jvh._full_step_pallas(
        mj._stacked_fz, jnp.asarray(frame), b.pk, b.lcc, b.vorig, b.uorig,
        b.allv, b.ry, b.rx, btab_static=jvh._btab_static(b),
        mask_params=mj._mask_params_t, use_hsv=True,
        fig_thresholds=mj._fig_thresholds,
        inner_thresholds=mj._inner_thresholds,
        views_threshold=mj.rig.views_threshold, layout=layout,
        interpret=True)


@pytest.mark.parametrize("layout", ["canonical", "blocked"])
def test_fast_step_matches_full_step_pallas(models, layout):
    mj, mt, _, frames = models
    occ_j, col_j, ovf_j = _jax_step(mj, frames[0], layout)
    assert not np.asarray(ovf_j).any()
    occ_t, col_t = mt.process_frame_fast(frames[0], layout=layout)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    assert occ_t.numpy().sum() > 50


def test_table_path_matches(models):
    mj, mt, _, frames = models
    occ_j, col_j = mj.process_frame(frames[1])
    occ_t, col_t = mt.process_frame(frames[1])
    occ_j = np.asarray(occ_j)
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    occ_f, col_f = mt.process_frame_fast(frames[1])  # the fast path agrees
    np.testing.assert_array_equal(occ_f.numpy(), occ_j)
    np.testing.assert_array_equal(col_f.numpy()[occ_j],
                                  np.asarray(col_j)[occ_j])


def test_overflow_frame_redone_exactly(models):
    mj, mt, bg, _ = models
    rng = np.random.default_rng(9)
    frame = _frame(rng, bg, (60.0, -40.0, -650.0), speckle=0)
    frame[:, ::3, ::3] = FG_BGR  # > kf isolated components per camera
    _, _, ovf_j = _jax_step(mj, frame, "blocked")
    mt._ensure_fast_state()
    occ_s, col_s, ovf_t = tvh._full_step(
        mt._stage, torch.from_numpy(frame), mt._btab, views_threshold=4,
        layout="blocked")
    np.testing.assert_array_equal(ovf_t.numpy(), np.asarray(ovf_j))
    assert ovf_t.numpy().any()
    # the JAX package's redo: device masks with host-CCL cameras, then carve
    masks_j = mj.masks(frame)
    for layout in ("blocked", "canonical"):
        occ_j, col_j = jcp.carve_blocked(
            jnp.asarray(masks_j), jnp.asarray(frame[1]), mj._btab,
            views_threshold=4, interpret=True, layout=layout)
        occ_t, col_t = mt.process_frame_fast(frame, layout=layout)
        np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
        np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    np.testing.assert_array_equal(mt.masks(frame).numpy(), masks_j)


def test_stream_matches_per_frame(models):
    _, mt, _, frames = models
    got = list(mt.stream(iter(frames), layout="blocked"))
    assert len(got) == len(frames)
    for (occ, col), fr in zip(got, frames):
        occ1, col1 = mt.process_frame_fast(fr, layout="blocked")
        np.testing.assert_array_equal(occ.numpy(), occ1.numpy())
        np.testing.assert_array_equal(col.numpy(), col1.numpy())


def test_background_models_cross_load(models, tmp_path):
    mj, mt, _, frames = models
    mj.save_background_models(str(tmp_path / "from_jax"))
    m2 = tvh.VisualHull(mt.cameras, mt.grid, mt.rig, mt.mask_params,
                        device="cpu")
    assert not m2.load_background_models(str(tmp_path / "missing"))
    assert m2.load_background_models(str(tmp_path / "from_jax"))
    for a, b in zip(m2.bg_states, mt.bg_states):
        for name in ("weight", "mean", "var", "nframes"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          getattr(b, name).numpy())
    occ2, col2 = m2.process_frame_fast(frames[2])
    occ1, col1 = mt.process_frame_fast(frames[2])
    np.testing.assert_array_equal(occ2.numpy(), occ1.numpy())
    np.testing.assert_array_equal(col2.numpy(), col1.numpy())
    # and back: the port's files load into the JAX package
    mt.save_background_models(str(tmp_path / "from_torch"))
    mj2 = jvh.VisualHull.__new__(jvh.VisualHull)
    mj2.rig = mj.rig
    assert mj2.load_background_models(str(tmp_path / "from_torch"))
    for a, b in zip(mj2.bg_states, mj.bg_states):
        np.testing.assert_array_equal(np.asarray(a.weight),
                                      np.asarray(b.weight))
        np.testing.assert_array_equal(np.asarray(a.mean), np.asarray(b.mean))


def test_cuda_default_raises_without_a_card(models):
    _, mt, _, _ = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvh.VisualHull(mt.cameras, mt.grid, mt.rig)


def test_odd_grid_fast_path_raises(models):
    """A grid not divisible by 8·sup has no blocked tables: the blocked
    carve and ``stream`` raise, and ``process_frame_fast`` takes the table
    step, equal to the table path."""
    _, mt, _, frames = models
    m2 = tvh.VisualHull(mt.cameras, tconfig.GridConfig(nx=20, ny=16, nz=16),
                        mt.rig, mt.mask_params, device="cpu")
    m2.bg_states, m2.mog_params = mt.bg_states, mt.mog_params
    with pytest.raises(ValueError, match="divisible"):
        m2.process_frame_fast(frames[0], carve_kernel="blocked")
    with pytest.raises(ValueError, match="divisible"):
        next(m2.stream(iter(frames)))
    occ, col = m2.process_frame(frames[0])  # the table path still runs
    assert occ.shape == (20 * 16 * 16,)
    occ_f, col_f = m2.process_frame_fast(frames[0])
    assert torch.equal(occ_f, occ) and torch.equal(col_f, col)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_in_flight_order(depth):
    """The streams' queue: item N + ``depth`` is dispatched before item N
    is resolved (and no later item), and the results come out in input
    order."""
    log = []

    def dispatch(i):
        log.append(("dispatch", i))
        return i

    def resolve(i):
        log.append(("resolve", i))
        return 10 * i

    n = 7
    got = list(tvh._in_flight(iter(range(n)), dispatch, resolve, depth))
    assert got == [10 * i for i in range(n)]
    at = {e: k for k, e in enumerate(log)}
    assert len(at) == 2 * n
    for i in range(n):
        if i + depth < n:
            assert at["dispatch", i + depth] < at["resolve", i]
        if i + depth + 1 < n:
            assert at["resolve", i] < at["dispatch", i + depth + 1]
