"""Port parity of the packed viewer wire and ``VisualHull.stream_viewer``.

On the CPU the port's ``pack_blocked_outputs`` + ``encode_wire`` give
``vbr_tpu.ops.carve_pallas``'s bytes, whole buffers compared; its
``_full_step(layout="packed")`` gives ``_full_step_pallas(...,
layout="packed", interpret=True)``'s for each ingest format; and
``stream_viewer`` gives the viewer arrays of ``vbr_tpu``'s stream rebuilt
from its parts (``vbr_tpu``'s own ``stream_viewer`` always runs its Pallas
kernels compiled, which XLA:CPU cannot), overflow frames included.  The
native emission tail equals its numpy reference.  Every comparison is
exact.
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
from vbr_tpu_torch import native
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import carve_blocked as tcb
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops import marching_cubes as tmc
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


# a rig small enough for the CPU, large enough that the ROI tracker's
# windows (with its 24-pixel margins) hold the subject
H, W, C, K = 96, 128, 4, 50
ROI_HW = (80, 96)
GRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)
FG_BGR = np.array([30, 220, 250], np.uint8)
INGESTS = ("bgr", "yuv420", "yuv420_roi")


def _frame(rng, bg, cams, center, speckle=20, holes=6):
    """Background + painted sphere silhouettes + speckle + holes."""
    fr = bg.copy()
    for c, cp in enumerate(cams):
        sil = tsyn.sphere_silhouette_mask(cp, np.asarray(center), 420.0,
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


def build_models(seed=5, figure_threshold=200.0):
    """(``vbr_tpu`` model, the port's CPU model, background, frames): the
    same cameras, seeded 50-mixture MOG states and mask parameters, four
    frames of a sphere moving a little."""
    rng = np.random.default_rng(seed)
    # 2×2-constant background: its YUV 4:2:0 round trip stays within the
    # model's match distance, as a real rig's smooth background does
    bg = rng.integers(40, 200, size=(C, H // 2, W // 2, 3), dtype=np.uint8)
    bg = bg.repeat(2, axis=1).repeat(2, axis=2)
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
    mp = [dataclasses.replace(p, figure_threshold=figure_threshold,
                              inner_threshold=8.0)
          for p in jconfig.DEFAULT_MASK_PARAMS]
    cams = tsyn.synthetic_cameras(C, image_hw=(H, W), f=110.0)
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=110.0),
                        jconfig.GridConfig(**GRID),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    mj.bg_states = states
    mj.mog_params = [jconfig.MOGParams()] * C
    mt = tvh.VisualHull(cams, tconfig.GridConfig(**GRID),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in mp],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s, "cpu") for s in states]
    mt.mog_params = [tconfig.MOGParams()] * C
    frames = [_frame(rng, bg, cams, (40.0 + 25 * i, -40.0 + 10 * i, -650.0))
              for i in range(4)]
    return mj, mt, bg, frames


def overflow_frame(bg, cams):
    """A frame whose speckle overflows the device component tables."""
    fr = _frame(np.random.default_rng(9), bg, cams, (40.0, -40.0, -650.0),
                speckle=0)
    fr[:, ::3, ::3] = FG_BGR
    return fr


@pytest.fixture(scope="module")
def models():
    return build_models()


def jax_step(mj, upload, layout, ingest="bgr", roi_offsets=None):
    """``vbr_tpu``'s whole step with its Pallas kernels interpreted."""
    mj._ensure_fast_state()
    mj._ensure_btab()
    b = mj._btab
    return jvh._full_step_pallas(
        mj._stacked_fz, jnp.asarray(upload), b.pk, b.lcc, b.vorig, b.uorig,
        b.allv, b.ry, b.rx, btab_static=jvh._btab_static(b),
        mask_params=mj._mask_params_t, use_hsv=True,
        fig_thresholds=mj._fig_thresholds,
        inner_thresholds=mj._inner_thresholds,
        views_threshold=mj.rig.views_threshold, layout=layout,
        interpret=True, ingest=ingest,
        roi_offsets=None if roi_offsets is None else jnp.asarray(roi_offsets))


def jax_stream_viewer(mj, frames, ingest):
    """``vbr_tpu``'s ``stream_viewer`` rebuilt from its parts (its upload
    preparation and tracker, the packed step, the decoder, the unpack and
    the exact fallback), with the kernels interpreted; also the modes the
    frames took."""
    mj._ensure_fast_state()
    mj._ensure_btab()
    tracker = mj._roi_tracker(ROI_HW) if ingest == "yuv420_roi" else None
    outs, modes = [], []
    for fr in frames:
        mode, upload, roi_off = mj._ingest_prepare(ingest, tracker, fr)
        wire = np.asarray(jax_step(mj, upload, "packed", mode, roi_off))
        modes.append(mode)
        any_ovf, nb, nv, ids, packed_k, cols = jcp.decode_wire(
            wire, total_voxels=mj.grid.num_voxels)
        if any_ovf:
            occ, col = jcp.carve_blocked(
                jnp.asarray(mj.masks(fr)), jnp.asarray(fr[mj.rig.color_camera]),
                mj._btab, views_threshold=mj.rig.views_threshold,
                interpret=True, layout="blocked")
            outs.append(jcp.compact_voxels_blocked(
                occ, col, mj._btab, mj.grid, mj.rig.scaling_factor))
        else:
            outs.append(jcp.viewer_arrays_from_packed(
                packed_k, ids, nb, nv, cols, mj._btab, mj.grid,
                mj.rig.scaling_factor))
    return outs, modes


@pytest.fixture(scope="module")
def blocked_outputs(models):
    """The port's blocked occupancy and colours of two frames."""
    _, mt, _, frames = models
    return [mt.process_frame_fast(fr, layout="blocked") for fr in frames[:2]]


@pytest.mark.parametrize("caps", [None, (512, 40), (3, 98304), (4, 7)])
def test_pack_and_encode_match(models, blocked_outputs, caps):
    """Whole wire buffers byte-equal, at the default capacities and at
    capacities the frame overflows (blocks, voxels, both), where ``ids``
    past the count repeat the last sub-block and colour rows repeat voxel
    0's."""
    for occ, col in blocked_outputs:
        kw = {} if caps is None else dict(k_blocks=caps[0], k_voxels=caps[1])
        got = tcb.pack_blocked_outputs(occ, col, **kw)
        want = jcp.pack_blocked_outputs(jnp.asarray(occ.numpy()),
                                        jnp.asarray(col.numpy()), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert bool(got[5]) == (caps is not None)
        for any_ovf in (False, True):
            g = tcb.encode_wire(*got[:5], torch.tensor(any_ovf))
            w = jcp.encode_wire(*want[:5], jnp.asarray(any_ovf))
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_and_unpack_match_compact_voxels_blocked(models,
                                                        blocked_outputs):
    """The wire is lossless: decoded and unpacked, it gives the rows of
    ``compact_voxels_blocked`` in both packages."""
    mj, mt, _, _ = models
    mj._ensure_btab()
    for occ, col in blocked_outputs:
        wire = tcb.encode_wire(*tcb.pack_blocked_outputs(occ, col)[:5],
                               torch.tensor(False))
        got = tcb.decode_wire(wire, total_voxels=mt.grid.num_voxels)
        want = jcp.decode_wire(wire.numpy(), total_voxels=mj.grid.num_voxels)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0] == 0 and got[2] == int(occ.sum()) > 50
        arrays = tcb.viewer_arrays_from_packed(got[4], got[3], got[1],
                                               got[2], got[5], mt._btab,
                                               mt.grid)
        for a, b, c in zip(
                arrays,
                jcp.viewer_arrays_from_packed(want[4], want[3], want[1],
                                              want[2], want[5], mj._btab,
                                              mj.grid),
                tcb.compact_voxels_blocked(occ, col, mt._btab, mt.grid)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_corrupt_wire_raises(models, blocked_outputs):
    _, mt, _, _ = models
    occ, col = blocked_outputs[0]
    got = list(tcb.decode_wire(tcb.encode_wire(
        *tcb.pack_blocked_outputs(occ, col)[:5], torch.tensor(False)),
        total_voxels=mt.grid.num_voxels))
    with pytest.raises(ValueError, match="corrupt wire"):
        tcb.viewer_arrays_from_packed(got[4], got[3], got[1], got[2] - 1,
                                      got[5], mt._btab, mt.grid)


def _uploads(mj, mt, frame):
    """The same frame as each ingest's upload (the ROI window where the
    tracker placed it after a first frame): {ingest: (upload, offsets)}."""
    tracker = mt._roi_tracker(ROI_HW)
    tracker.update(frame)
    offsets, full = tracker.update(frame)
    assert not full
    return {"bgr": (frame, None),
            "yuv420": (tcolor.bgr_to_yuv420_host(frame), None),
            "yuv420_roi": (tcolor.bgr_to_yuv420_host(tracker.crop(frame)),
                           offsets)}


@pytest.mark.parametrize("ingest", INGESTS)
def test_full_step_packed_matches(models, ingest):
    """``_full_step(layout="packed")`` on each upload format: the whole
    wire byte-equal to ``vbr_tpu``'s."""
    mj, mt, _, frames = models
    mt._ensure_fast_state()
    upload, off = _uploads(mj, mt, frames[1])[ingest]
    want = np.asarray(jax_step(mj, upload, "packed", ingest, off))
    got = mt._step(torch.from_numpy(upload), "blocked", "packed", ingest,
                   off)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert tcb.decode_wire(want, total_voxels=mt.grid.num_voxels)[2] > 50


@pytest.mark.parametrize("ingest", INGESTS)
def test_stream_viewer_matches(models, ingest):
    """``stream_viewer`` over four frames and an overflow frame: each
    frame's (positions, rgb) equal to ``vbr_tpu``'s, bit for bit; the
    ROI stream takes the windows after its first frame."""
    mj, mt, bg, frames = models
    seq = frames + [overflow_frame(bg, mt.cameras)]
    want, modes = jax_stream_viewer(mj, seq, ingest)
    got = list(mt.stream_viewer(iter(seq), depth=2, ingest=ingest,
                                roi_hw=ROI_HW))
    assert len(got) == len(seq)
    for (pos, rgb), (pos_j, rgb_j) in zip(got, want):
        assert pos.dtype == rgb.dtype == np.float32 and len(pos) > 0
        np.testing.assert_array_equal(pos, np.asarray(pos_j))
        np.testing.assert_array_equal(rgb, np.asarray(rgb_j))
    if ingest == "yuv420_roi":
        assert modes[0] == "yuv420" and "yuv420_roi" in modes[1:4]


def test_stream_viewer_bgr_is_lossless(models):
    """With BGR frames the wire loses nothing: ``compact_voxels_blocked``
    of ``process_frame_fast(layout="blocked")``, frame by frame."""
    _, mt, _, frames = models
    for (pos, rgb), fr in zip(mt.stream_viewer(iter(frames)), frames):
        want = tcb.compact_voxels_blocked(
            *mt.process_frame_fast(fr, layout="blocked"), mt._btab, mt.grid,
            mt.rig.scaling_factor)
        np.testing.assert_array_equal(pos, want[0])
        np.testing.assert_array_equal(rgb, want[1])


def test_stream_viewer_pack_overflow_takes_the_fallback(models,
                                                        monkeypatch):
    """A wire capacity below the frame's occupied sub-blocks sets the
    overflow word; the frame is redone exactly, as with the default."""
    _, mt, _, frames = models
    want = list(mt.stream_viewer(iter(frames[:2])))
    monkeypatch.setattr(tcb, "WIRE_K_BLOCKS", 4)
    wire = mt._step(torch.from_numpy(frames[0]), "blocked", "packed")
    assert tcb.decode_wire(wire, total_voxels=mt.grid.num_voxels)[0] == 1
    got = list(mt.stream_viewer(iter(frames[:2])))
    for (pos, rgb), (pos_w, rgb_w) in zip(got, want):
        np.testing.assert_array_equal(pos, pos_w)
        np.testing.assert_array_equal(rgb, rgb_w)


def test_stream_viewer_refuses(models):
    _, mt, _, frames = models
    with pytest.raises(ValueError, match="ingest"):
        next(mt.stream_viewer(iter(frames), ingest="jpeg"))
    grid = tconfig.GridConfig(**dict(GRID, nx=20))
    m = tvh.VisualHull(mt.cameras, grid, mt.rig, mt.mask_params,
                       device="cpu")
    m.bg_states, m.mog_params = mt.bg_states, mt.mog_params
    with pytest.raises(ValueError, match="stream_viewer needs grid dims"):
        next(m.stream_viewer(iter(frames)))


@pytest.mark.parametrize("pair", [("cubes", "join"),
                                  ("tetrahedra", "separate")])
def test_native_emission_equals_numpy(pair):
    """``native.mc_emit`` against ``_triangles_from_wire_numpy`` on every
    configuration at random cells and a non-unit placement: bit-equal."""
    rng = np.random.default_rng(11)
    tv, tvalid = tmc._binary_emit_table(*pair, 0.5)
    shape = (33, 17, 29)
    n = 3000
    idx = rng.integers(0, 32 * 16 * 28, n).astype(np.int32)
    cfg = rng.integers(0, 256, n).astype(np.uint8)
    cfg[:256] = np.arange(256)
    origin, spacing = (-900.0, -1050.5, -1700.25), (15.873, 62.5, 64.51)
    want = tmc._triangles_from_wire_numpy(idx, cfg, n, tv, tvalid,
                                          shape[1] - 1, shape[2] - 1, origin,
                                          spacing)
    got = tmc.triangles_from_wire(idx, cfg, n, shape, origin, spacing,
                                  *pair)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    T = tv.shape[1]
    few = native.mc_emit(idx, cfg, 10 ** 6, tv.reshape(256, T, 9), tvalid,
                         shape[1] - 1, shape[2] - 1, origin, spacing)
    np.testing.assert_array_equal(few, want.reshape(-1, 9))  # n clipped
    with pytest.raises(ValueError, match="256, T, 9"):
        native.mc_emit(idx, cfg, n, tv, tvalid, 16, 28, origin, spacing)
