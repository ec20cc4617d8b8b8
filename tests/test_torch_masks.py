"""Port parity: HSV, morphology, the frozen MOG apply, the batched
raw-mask stage and the whole mask stage (``MaskStage``), against
``vbr_tpu`` on the same seeded numpy inputs (integer or exact f32
arithmetic: zero tolerance)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.ops import ccl as jccl
from vbr_tpu.ops import color as jcolor
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.ops import morphology as jmorph
from vbr_tpu.pipelines import background as jbg
from vbr_tpu.utils import config as jconfig
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops import gmm as tgmm
from vbr_tpu_torch.ops import morphology as tmorph
from vbr_tpu_torch.pipelines import background as tbg
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W, K = 40, 56, 50


def mog_arrays(rng, bg_hsv, K=K, n_slots=4):
    """A frozen MOG state as numpy: a few weighted slots whose means sit
    near the background HSV, empty slots after them."""
    shape = bg_hsv.shape[:-1]
    w = np.zeros(shape + (K,), np.float32)
    raw = rng.dirichlet([8.0, 4.0, 1.0, 0.5][:n_slots], size=shape)
    w[..., :n_slots] = raw.astype(np.float32)
    mean = np.zeros(shape + (K, 3), np.float32)
    mean[..., :n_slots, :] = (bg_hsv[..., None, :].astype(np.float32)
                              + rng.normal(0, 6, shape + (n_slots, 3)))
    var = np.zeros(shape + (K,), np.float32)
    var[..., :n_slots] = rng.uniform(60.0, 900.0, shape + (n_slots,))
    return w, mean, var


def _states(w, mean, var):
    js = jgmm.MOGState(weight=jnp.asarray(w), mean=jnp.asarray(mean),
                       var=jnp.asarray(var), nframes=jnp.int32(30))
    ts = tart.from_numpy_state(js, "cpu")
    return js, ts


def test_hsv_dense_sample_bit_exact():
    v = np.arange(0, 256, 3, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    dense = np.stack([b, g, r], -1).reshape(-1, 3)
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 256, size=(100_000, 3), dtype=np.uint8)
    bgr = np.concatenate([dense, rand])
    np.testing.assert_array_equal(
        tcolor.bgr_to_hsv_u8(torch.from_numpy(bgr)).numpy(),
        np.asarray(jcolor.bgr_to_hsv_u8(jnp.asarray(bgr))))


@pytest.mark.parametrize("ksize", [(3, 3), (2, 2), (2, 3)])
def test_morphology_matches(ksize):
    rng = np.random.default_rng(1)
    img = np.where(rng.random((2, 33, 47)) < 0.4, 255, 0).astype(np.uint8)
    for name in ("erode", "dilate", "opening", "closing"):
        for c in range(2):
            got = getattr(tmorph, name)(torch.from_numpy(img[c]), ksize)
            want = getattr(jmorph, name)(jnp.asarray(img[c]), ksize)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_frozen_apply_and_compression_match():
    rng = np.random.default_rng(2)
    bg = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    js, ts = _states(*mog_arrays(rng, bg_hsv))
    p = jconfig.MOGParams()
    frame = bg_hsv.copy()
    frame[rng.random((H, W)) < 0.3] = rng.integers(0, 256, 3)
    jfz, jk = jgmm.compress_frozen(js, p)
    tfz, tk = tgmm.compress_frozen(ts, tconfig.MOGParams())
    assert tk == jk and tk < K
    np.testing.assert_array_equal(tfz.bcount.numpy(), np.asarray(jfz.bcount))
    np.testing.assert_array_equal(tfz.thr.numpy(), np.asarray(jfz.thr))
    np.testing.assert_array_equal(tfz.mean.numpy(), np.asarray(jfz.mean))
    full = tgmm.apply_frozen(ts, torch.from_numpy(frame), tconfig.MOGParams())
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jgmm.apply_frozen(js, jnp.asarray(frame), p)))
    comp = tgmm.apply_frozen_compressed(tfz, torch.from_numpy(frame))
    np.testing.assert_array_equal(comp.numpy(), full.numpy())
    assert 0 < (comp.numpy() > 0).mean() < 1


def test_raw_and_finalize_masks_batched_match():
    rng = np.random.default_rng(3)
    C = 4
    bg = rng.integers(0, 256, size=(C, H, W, 3), dtype=np.uint8)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    arrays = [mog_arrays(rng, bg_hsv[c]) for c in range(C)]
    pairs = [_states(*a) for a in arrays]
    frames = bg.copy()
    frames[:, 8:30, 10:40] = rng.integers(0, 256, 3)
    frames[rng.random((C, H, W)) < 0.05] = 255
    mp_j = tuple(jconfig.DEFAULT_MASK_PARAMS)
    mp_t = tuple(tconfig.DEFAULT_MASK_PARAMS)
    jfz = jbg.stack_frozen([j for j, _ in pairs], jconfig.MOGParams())
    tfz = tbg.stack_frozen([t for _, t in pairs], tconfig.MOGParams(),
                            "cpu")
    for name in ("mean", "thr", "bcount"):
        np.testing.assert_array_equal(getattr(tfz, name).numpy(),
                                      np.asarray(getattr(jfz, name)))
    raw_j = jbg.raw_masks_batched_fz(jfz, jnp.asarray(frames), mp_j, True)
    raw_t = tbg.raw_masks_batched_fz(tfz, torch.from_numpy(frames), mp_t)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
    fin_j = jbg.finalize_masks_batched(raw_j, mp_j)
    fin_t = tbg.finalize_masks_batched(raw_t, mp_t)
    np.testing.assert_array_equal(fin_t.numpy(), np.asarray(fin_j))
    # every pre/post morphology flag combination is exercised
    assert {dataclasses.astuple(p)[2:] for p in mp_t} >= {
        (False, False, True, True), (False, True, True, True),
        (False, False, False, True)}


ROI = (24, 32)  # the ROI ingest's window (even: its YUV 4:2:0 pack)


def _upload(frames, ingest, offsets):
    """(C, H, W, 3) u8 BGR → what the ingest ``ingest`` uploads."""
    if ingest == "bgr":
        return frames
    if ingest == "yuv420_roi":
        frames = np.stack([f[y0:y0 + ROI[0], x0:x0 + ROI[1]]
                           for f, (y0, x0) in zip(frames, offsets)])
    return tcolor._bgr_to_yuv420_numpy(frames)


@pytest.fixture(scope="module")
def stage_case():
    """Both packages' mask stage on the same four seeded states: (the
    port's ``MaskStage``, its torch states, the frames of three frame
    times, their ROI offsets, ``vbr_tpu``'s stage on frame f as
    ``reference(f, ingest)`` → (masks, overflow, BGR frames) numpy)."""
    rng = np.random.default_rng(7)
    C = 4
    # 2×2-constant background: its YUV 4:2:0 round trip stays background
    bg = rng.integers(40, 200, size=(C, H // 2, W // 2, 3), dtype=np.uint8)
    bg = bg.repeat(2, axis=1).repeat(2, axis=2)
    bg_hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    pairs = [_states(*mog_arrays(rng, bg_hsv[c])) for c in range(C)]
    mp_j = tuple(dataclasses.replace(p, figure_threshold=40.0,
                                     inner_threshold=8.0)
                 for p in jconfig.DEFAULT_MASK_PARAMS)
    mp_t = [tconfig.MaskParams(**dataclasses.asdict(p)) for p in mp_j]
    states = [t for _, t in pairs]
    stage = tbg.MaskStage.build(states, [tconfig.MOGParams()] * C, mp_t,
                                "cpu")
    jfz = jbg.stack_frozen([j for j, _ in pairs], jconfig.MOGParams())
    frames = np.stack([bg] * 3)
    for f in range(2):  # a subject with speckle
        frames[f, :, 6 + 6 * f:26 + 6 * f, 8 + 8 * f:36 + 8 * f] = (
            rng.integers(0, 256, 3))
        frames[f][rng.random((C, H, W)) < 0.03] = 255
    frames[2, :, ::2, ::2] = 255  # more components than K2's tables hold
    offsets = np.stack([[(2 * c + 5 * f, 3 * c + 7 * f) for c in range(C)]
                        for f in range(3)]).astype(np.int32)
    fig = tuple(p.figure_threshold for p in mp_j)
    inner = tuple(p.inner_threshold for p in mp_j)
    cache = {}

    def reference(f, ingest):
        if (f, ingest) not in cache:
            up = jnp.asarray(_upload(frames[f], ingest, offsets[f]))
            with jax.disable_jit():  # the exact unpack (no contraction)
                bgr = up if ingest == "bgr" else jcolor.yuv420_to_bgr_u8(up)
            if ingest == "yuv420_roi":
                off = jnp.asarray(offsets[f])
                raw = jbg.raw_masks_batched_fz_roi(jfz, bgr, off, mp_j, True,
                                                   image_hw=(H, W))
                bgr = jbg.paste_rois(bgr, off, (H, W))
            else:
                raw = jbg.raw_masks_batched_fz(jfz, bgr, mp_j, True)
            cleaned, ovf = jccl.clean_masks_batched(raw, fig, inner,
                                                    interpret=True)
            cache[f, ingest] = tuple(np.asarray(x) for x in (
                jbg.finalize_masks_batched(cleaned, mp_j), ovf, bgr))
        return cache[f, ingest]

    return stage, states, frames, offsets, reference


@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("ingest", ["bgr", "yuv420", "yuv420_roi"])
def test_mask_stage_matches_the_reference(stage_case, ingest, nf):
    """``MaskStage`` on one upload, and on three with a leading frame
    axis: masks, overflow bits and BGR frames equal ``vbr_tpu``'s
    ``raw_masks_batched_fz``/``_roi`` → ``ccl.clean_masks_batched`` →
    ``finalize_masks_batched``, frame by frame."""
    stage, _, frames, offsets, reference = stage_case
    ups = np.stack([_upload(frames[f], ingest, offsets[f])
                    for f in range(nf)])
    off = offsets[:nf] if ingest == "yuv420_roi" else None
    if nf == 1:
        got = stage(torch.from_numpy(ups[0]), ingest,
                    None if off is None else off[0])
        got = [x[None] for x in got]
    else:
        got = stage(torch.from_numpy(ups), ingest, off)
    C = len(frames[0])
    assert [tuple(x.shape) for x in got] == [(nf, C, H, W), (nf, C),
                                             (nf, C, H, W, 3)]
    for f in range(nf):
        for g, w in zip(got, reference(f, ingest)):
            np.testing.assert_array_equal(g[f].numpy(), w)
    masks, ovf, _ = got
    assert 0 < int((masks[0] > 0).sum()) < masks[0].numel()
    if nf == 3 and ingest != "yuv420_roi":  # the burst frame overflows
        assert bool(ovf[2].any()) and not bool(ovf[:2].any())


def test_mask_stage_refuses_mixed_apply_params(stage_case):
    """The batched apply needs one set of apply parameters."""
    _, states, _, _, _ = stage_case
    mog = [tconfig.MOGParams()] * len(states)
    mog[1] = tconfig.MOGParams(bg_ratio=0.8)
    with pytest.raises(ValueError, match="uniform MOG apply params"):
        tbg.MaskStage.build(states, mog, tconfig.DEFAULT_MASK_PARAMS, "cpu")
