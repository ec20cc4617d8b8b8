"""Port parity of the reduced-byte ingest: the YUV 4:2:0 wire format, the
ROI mask stage, the ROI tracker, ``validate_reduced_ingest`` and
``stream_surface(ingest=...)``.

Inputs are made from a numpy seed on the small rig of
``tests/test_torch_wire.py``.  Every comparison with ``vbr_tpu`` is exact,
except ``yuv420_to_bgr_u8`` against ``vbr_tpu``'s jitted build, which may
contract ``y + 1.402·v`` into a fused multiply-add: there ±1 count is
allowed, and the number of differing pixels is printed (under
``jax.disable_jit()`` it is exact).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_wire import (C, H, ROI_HW, W, build_models, jax_step,
                                   overflow_frame)
from vbr_tpu.ops import color as jcolor
from vbr_tpu.ops import marching_cubes as jmc
from vbr_tpu.pipelines import background as jbg
from vbr_tpu.utils import roi as jroi
from vbr_tpu_torch import native
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.pipelines import background as tbg
from vbr_tpu_torch.utils import roi as troi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.mark.parametrize("shape", [(4, 64, 96, 3), (3, 34, 48, 3),
                                   (34, 48, 3), (2, 3, 8, 10, 3)])
def test_yuv420_pack_matches(shape):
    """The numpy pack, the native pack and the host entry point: byte-equal
    to ``vbr_tpu``'s pack."""
    rng = np.random.default_rng(len(shape) + shape[-2])
    fr = rng.integers(0, 256, size=shape, dtype=np.uint8)
    fr[..., :4, :4, :] = (0, 255, 255)  # the clip's ends
    want = jcolor._bgr_to_yuv420_numpy(fr)
    assert want.shape == shape[:-3] + (shape[-3] * 3 // 2, shape[-2])
    np.testing.assert_array_equal(tcolor._bgr_to_yuv420_numpy(fr), want)
    np.testing.assert_array_equal(tcolor.bgr_to_yuv420_host(fr), want)
    if len(shape) == 4:
        np.testing.assert_array_equal(native.yuv420_pack(fr), want)


def test_native_pack_refuses_bad_shapes():
    with pytest.raises(ValueError, match="even"):
        native.yuv420_pack(np.zeros((1, 5, 8, 3), np.uint8))
    with pytest.raises(ValueError, match=r"\(C, H, W, 3\)"):
        native.yuv420_pack(np.zeros((5, 8, 3), np.uint8))


def _packed_inputs():
    rng = np.random.default_rng(21)
    fr = rng.integers(0, 256, size=(3, 34, 48, 3), dtype=np.uint8)
    return [jcolor._bgr_to_yuv420_numpy(fr),
            rng.integers(0, 256, size=(2, 51, 40), dtype=np.uint8)]


@pytest.mark.parametrize("which", [0, 1])
def test_yuv420_unpack_exact_op_by_op(which):
    """Against ``vbr_tpu`` run op by op (``jax.disable_jit()``): exact, on
    a pack of random frames and on random bytes (every chroma value)."""
    packed = _packed_inputs()[which]
    with jax.disable_jit():
        want = np.asarray(jcolor.yuv420_to_bgr_u8(jnp.asarray(packed)))
    got = tcolor.yuv420_to_bgr_u8(torch.from_numpy(packed))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", [0, 1])
def test_yuv420_unpack_within_one_of_the_jitted_build(which):
    """Against ``vbr_tpu``'s jitted build: within ±1 count (a contracted
    multiply-add may round a tie the other way); the differing pixels are
    counted and printed."""
    packed = _packed_inputs()[which]
    want = np.asarray(jcolor.yuv420_to_bgr_u8(jnp.asarray(packed)))
    got = tcolor.yuv420_to_bgr_u8(torch.from_numpy(packed)).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"yuv420_to_bgr_u8: {int((diff > 0).sum())} of {diff.size} values "
          "differ from the jitted build")
    assert int(diff.max()) <= 1


# window origins (y0, x0) for a 48×64 window in the 96×128 image; in the
# second set the JAX ops count negative ones from the end and clamp every
# one so that the window fits
OFFSETS = [[(8, 16), (0, 0), (48, 64), (30, 10)],
           [(-6, 90), (70, -3), (200, 200), (-200, 63)]]


@pytest.mark.parametrize("which", [0, 1])
def test_roi_mask_stage_and_paste_match(models, which):
    """``raw_masks_batched_fz_roi`` and ``paste_rois`` on windows of a
    frame: equal to ``vbr_tpu``'s, also at offsets the JAX ops clamp."""
    mj, mt, _, frames = models
    mj._ensure_fast_state()
    mt._ensure_fast_state()
    off = np.asarray(OFFSETS[which], np.int32)
    rh, rw = 48, 64
    rng = np.random.default_rng(which)
    rois = rng.integers(0, 256, size=(C, rh, rw, 3), dtype=np.uint8)
    for c, (y0, x0) in enumerate(off):
        y0, x0 = tbg._window_origin((y0, x0), (rh, rw), (H, W))
        rois[c, :rh // 2] = frames[0][c, y0:y0 + rh // 2, x0:x0 + rw]
    want = np.asarray(jbg.raw_masks_batched_fz_roi(
        mj._stacked_fz, jnp.asarray(rois), jnp.asarray(off),
        mj._mask_params_t, True, image_hw=(H, W)))
    got = tbg.raw_masks_batched_fz_roi(mt._stacked_fz, torch.from_numpy(rois),
                                       off, mt.mask_params, True,
                                       image_hw=(H, W))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((want > 0).sum()) < want.size
    np.testing.assert_array_equal(
        tbg.paste_rois(torch.from_numpy(rois), off, (H, W)).numpy(),
        np.asarray(jbg.paste_rois(jnp.asarray(rois), jnp.asarray(off),
                                  (H, W))))


def _toy_trackers(Ht, Wt, roi, figure_threshold=300.0):
    """Both packages' trackers over one single-mixture BGR background at
    value 60 (as ``tests/test_reduced_ingest.py``'s)."""
    mean = np.full((2, Ht, Wt, 1, 3), 60.0, np.float32)
    thr = np.full((2, Ht, Wt, 1), 900.0, np.float32)
    bcount = np.ones((2, Ht, Wt), np.int32)
    kw = dict(use_hsv=False, figure_threshold=figure_threshold, margin=8,
              stride=4)
    return (jroi.MotionROITracker(mean, thr, bcount, roi, **kw),
            troi.MotionROITracker(mean, thr, bcount, roi, **kw))


def _toy_sequence(case):
    Ht, Wt = 128, 192
    base = np.full((2, Ht, Wt, 3), 60, np.uint8)
    subject = base.copy()
    subject[:, 40:64, 60:84] = 200
    specks = subject.copy()
    for (y, x) in ((8, 8), (120, 180), (100, 12)):
        specks[:, y:y + 4, x:x + 4] = 200
    blob = subject.copy()
    blob[:, 90:126, 130:180] = 200
    moved = base.copy()
    moved[:, 42:66, 64:88] = 200
    big = base.copy()
    big[:, 10:120, 20:180] = 200
    one_cam = subject.copy()
    one_cam[1] = 60  # camera 1 sees nothing: it keeps its last window
    seqs = {"follows": [subject, moved, moved, big, one_cam],
            "specks and blobs": [subject, specks, blob, specks, base]}
    return seqs[case]


@pytest.mark.parametrize("case", ["follows", "specks and blobs"])
@pytest.mark.parametrize("figure_threshold", [300.0, 20000.0])
def test_tracker_matches_on_toy_sequences(case, figure_threshold):
    """The port's tracker (scipy labelling, its own HSV) against
    ``vbr_tpu``'s (cv2) over five frames: offsets and the full-frame signal
    equal frame by frame, crops too."""
    tj, tt = _toy_trackers(128, 192, (64, 64), figure_threshold)
    fulls = []
    for fr in _toy_sequence(case):
        off_j, full_j = tj.update(fr)
        off_t, full_t = tt.update(fr)
        np.testing.assert_array_equal(off_t, off_j)
        assert full_t == full_j
        assert off_t.dtype == np.int32
        np.testing.assert_array_equal(tt.crop(fr), tj.crop(fr))
        fulls.append(full_t)
    assert fulls[0]  # the first frame always goes full
    if figure_threshold == 300.0:
        assert not fulls[1] and fulls[3 if case == "follows" else 2]


def test_tracker_matches_on_the_model(models):
    """Both trackers seeded by the same frozen model (HSV) over five
    frames of the small rig: equal offsets and signals every frame."""
    mj, mt, bg, frames = models
    mj._ensure_fast_state()
    mt._ensure_fast_state()
    tj, tt = mj._roi_tracker(ROI_HW), mt._roi_tracker(ROI_HW)
    seq = frames + [overflow_frame(bg, mt.cameras)]
    fulls = []
    for fr in seq:
        off_j, full_j = tj.update(fr)
        off_t, full_t = tt.update(fr)
        np.testing.assert_array_equal(off_t, off_j)
        assert full_t == full_j
        fulls.append(full_t)
    assert fulls == [True, False, False, False, True]


def test_keeper_bbox_matches_cv2():
    rng = np.random.default_rng(4)
    for _ in range(20):
        det = (rng.random((40, 60)) < rng.uniform(0.05, 0.5)).astype(np.uint8)
        for min_cells in (1, 3, 12, 10 ** 6):
            assert (troi._keeper_bbox(det, min_cells)
                    == jroi._keeper_bbox(det, min_cells))
    assert troi._keeper_bbox(np.zeros((5, 5), np.uint8), 1) is None


@pytest.mark.parametrize("ingest", ["yuv420", "yuv420_roi"])
def test_validate_reduced_ingest_matches(models, ingest):
    """The guard's dict on a CPU model equals ``vbr_tpu``'s."""
    mj, mt, _, frames = models
    want = mj.validate_reduced_ingest(frames[2], ingest=ingest,
                                      roi_hw=ROI_HW)
    got = mt.validate_reduced_ingest(frames[2], ingest=ingest, roi_hw=ROI_HW)
    assert got == want
    # the sphere's silhouettes are ~30 pixels across: their rims carry
    # most of the chroma loss
    assert got["occ_exact"] > 0 and got["mask_iou_min"] > 0.8
    with pytest.raises(ValueError, match="reduced ingest"):
        mt.validate_reduced_ingest(frames[2], ingest="bgr")


CAP = 32768


def _world(mj):
    xs, ys, zs = mj.grid.axis_ranges()
    return ((float(xs[0]), float(ys[0]), float(zs[0])),
            (float(xs[1] - xs[0]), float(ys[1] - ys[0]),
             float(zs[1] - zs[0])))


@pytest.mark.parametrize("transfer", ["full", "wire"])
def test_stream_surface_yuv420_matches(models, transfer):
    """``stream_surface(ingest="yuv420")`` against ``vbr_tpu``'s (its table
    branch on the CPU, which unpacks the same pack on the host), a
    component-overflow frame included: triangles and occupancy equal."""
    mj, mt, bg, frames = models
    seq = frames[:2] + [overflow_frame(bg, mt.cameras)]
    want = list(mj.stream_surface(iter(seq), capacity=CAP,
                                  transfer=transfer, ingest="yuv420"))
    got = list(mt.stream_surface(iter(seq), capacity=CAP, transfer=transfer,
                                 ingest="yuv420"))
    assert len(got) == len(seq)
    for (tris, occ), (tris_j, occ_j) in zip(got, want):
        occ = occ.numpy() if isinstance(occ, torch.Tensor) else occ
        np.testing.assert_array_equal(occ, np.asarray(occ_j))
        np.testing.assert_array_equal(tris, np.asarray(tris_j))
        assert len(tris) > 0


def test_stream_surface_roi_matches_the_roi_step(models):
    """``stream_surface(ingest="yuv420_roi")`` meshes the occupancy of
    ``vbr_tpu``'s ROI step (``_full_step_pallas``, interpreted), both
    transfers, and a grid not divisible by 8·sup takes the same ROI mask
    stage on the table step.  ``vbr_tpu``'s own table branch instead
    classifies the pasted frames whole (zeros outside the windows), which
    gives another hull: the port does not follow it there."""
    mj, mt, _, frames = models
    seq = frames[:3]
    tracker = mj._roi_tracker(ROI_HW)
    origin, spacing = _world(mj)
    want, modes = [], []
    for fr in seq:
        mode, upload, off = mj._ingest_prepare("yuv420_roi", tracker, fr)
        occ_j = np.asarray(jax_step(mj, upload, "canonical", mode, off)[0])
        tris_j, _ = jmc.extract_mesh(occ_j.reshape(mj.grid.shape), origin,
                                     spacing, algorithm="cubes",
                                     ambiguity="join")
        want.append((np.asarray(tris_j), occ_j))
        modes.append(mode)
    assert modes == ["yuv420", "yuv420_roi", "yuv420_roi"]
    for transfer in ("full", "wire"):
        got = list(mt.stream_surface(iter(seq), capacity=CAP,
                                     transfer=transfer, ingest="yuv420_roi",
                                     roi_hw=ROI_HW))
        for (tris, occ), (tris_j, occ_j) in zip(got, want):
            occ = occ.numpy() if isinstance(occ, torch.Tensor) else occ
            np.testing.assert_array_equal(occ, occ_j)
            np.testing.assert_array_equal(tris, tris_j)
    # what vbr_tpu's table branch classifies instead: the pasted frames
    mode, upload, off = mj._ingest_prepare("yuv420_roi", tracker, seq[2])
    rois = jcolor.yuv420_to_bgr_u8(jnp.asarray(upload))
    roi_raw = np.asarray(jbg.raw_masks_batched_fz_roi(
        mj._stacked_fz, rois, jnp.asarray(off), mj._mask_params_t, True,
        image_hw=(H, W)))
    pasted_raw = np.asarray(jbg.raw_masks_batched_fz(
        mj._stacked_fz, jbg.paste_rois(rois, jnp.asarray(off), (H, W)),
        mj._mask_params_t, True))
    assert (pasted_raw > 0).mean() > 5 * (roi_raw > 0).mean()


def test_table_step_takes_the_roi_mask_stage(models):
    """On the table step (``carve_kernel="tables"``) every ingest format
    gives the blocked step's occupancy."""
    _, mt, _, frames = models
    mt._ensure_fast_state()
    tracker = mt._roi_tracker(ROI_HW)
    for fr in frames[:2]:
        mode, upload, off = mt._ingest_prepare("yuv420_roi", tracker, fr)
        up = torch.from_numpy(upload)
        blocked = mt._step(up, mt._carve_kernel("blocked"), ingest=mode,
                           roi_offsets=off)
        tables = mt._step(up, mt._carve_kernel("tables"), ingest=mode,
                          roi_offsets=off)
        assert torch.equal(blocked[0], tables[0]) and int(tables[0].sum())
        on = tables[0]
        assert torch.equal(blocked[1][on], tables[1][on])


def test_stream_surface_capacity_fallback_uses_the_bgr_frames(models):
    """A reduced upload over the capacity is redone from its BGR frames,
    as ``vbr_tpu``'s host redo does."""
    mj, mt, _, frames = models
    want = list(mj.stream_surface(iter(frames[:1]), capacity=8,
                                  ingest="yuv420"))
    got = list(mt.stream_surface(iter(frames[:1]), capacity=8,
                                 ingest="yuv420"))
    np.testing.assert_array_equal(got[0][1].numpy(), np.asarray(want[0][1]))
    np.testing.assert_array_equal(got[0][0], np.asarray(want[0][0]))
    bgr = mt.process_frame(frames[0])[0]
    assert torch.equal(got[0][1], bgr)
