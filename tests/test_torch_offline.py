"""Port parity: the offline multi-frame carve (K4) and
``VisualHull.process_frames_offline``.

``vbr_tpu``'s counts kernel runs in interpret mode; the port runs K4's
plain version on the CPU.  Everything is integer, so occupancy, colour
indices and colours are compared with zero tolerance: against ``vbr_tpu``,
against the per-frame table carve, against a numpy model of K4's packed
counters and stores, and for a frame that overflows the device component
tables against the exact per-frame redo.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path

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
from vbr_tpu_torch.utils import profiling
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
    tt = tcb.build_block_tables(cams_t, tconfig.GridConfig(**GRID), (H, W),
                                device="cpu")
    ptab = tcarve.build_projection_tables(cams_t, tconfig.GridConfig(**GRID),
                                          (H, W), device="cpu")
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


@pytest.mark.parametrize("nf", [1, 2, 5])
def test_chunk_occupancy_is_row_major(carve_rig, nf):
    """(exact) A chunk's canonical occupancy comes back as a C-contiguous
    (NF, N) bool tensor, each frame equal to the per-frame table carve and
    to K4's plain output taken through the frame-last canonical order."""
    _, tt, ptab, masks = carve_rig
    chunk = torch.from_numpy(masks[:nf])
    got = tcb._carve_frames_device(chunk, tt, views_threshold=4)
    assert got.shape == (nf, 32**3) and got.dtype == torch.bool
    assert got.is_contiguous()
    active, full = tcb.chunk_activity(chunk, tt, 4)
    occ_b = tcb.carve_frames_plain(tt.pk, active, full, chunk,
                                   views_threshold=4)
    frame_last = tcb._blocked_to_canonical(
        occ_b.reshape(nf, tt.nsuper, -1).permute(1, 2, 0), tt.sub_shape,
        tt.sup_shape, tt.nblocks)  # (N, NF)
    assert torch.equal(got, frame_last.t().bool())
    images = torch.zeros((C, H, W, 3), dtype=torch.uint8)
    for f in range(nf):
        occ_f, _ = tcarve.carve_from_tables(chunk[f], images, ptab.valid,
                                            ptab.lin_idx, views_threshold=4)
        assert torch.equal(got[f], occ_f)


def test_k4_wrapper_uses_plain_on_cpu_only(carve_rig):
    _, tt, _, masks = carve_rig
    chunk = torch.from_numpy(masks[:2])
    act, full = tcb.chunk_activity(chunk, tt, 4)
    before = tcb.K4.launches
    got = tcb.carve_frames_kernel(tt.pk, act, full, chunk, views_threshold=4)
    want = tcb.carve_frames_plain(tt.pk, act, full, chunk, views_threshold=4)
    assert torch.equal(got, want) and got.shape == (2, tt.nsuper, tt.nsub, 512)
    assert tcb.K4.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        tcb.carve_frames_kernel(tt.pk.to("meta"), act.to("meta"),
                                full.to("meta"), chunk.to("meta"),
                                views_threshold=4)


# -- K4's design, as far as the CPU can hold it ----------------------------

ONES = np.uint32(0x01010101)


def _frames(masks, nf):
    """A chunk of ``nf`` frames of the rig: frame i is ``masks[i % F]``."""
    return np.ascontiguousarray(masks[np.arange(nf) % len(masks)])


def _vcmpgeu4(a, b):
    """``__vcmpgeu4``: 0xff in each byte where a's byte >= b's, else 0."""
    out = np.zeros_like(a)
    for k in range(4):
        ge = (a >> np.uint32(8 * k) & np.uint32(0xFF)) >= (
            b >> np.uint32(8 * k) & np.uint32(0xFF))
        out |= np.where(ge, np.uint32(0xFF) << np.uint32(8 * k),
                        np.uint32(0))
    return out


K4_GROUP = 8  # frames whose counters a thread keeps in registers


def _k4_model(pk, active, full, masks, thr):
    """K4's arithmetic in numpy: for each counted sub-block and thread, one
    32-bit counter word per frame (byte e = the count of voxel 4·tid + e),
    the threshold as the launcher clamps it, tested per byte, and the
    frame's word stored at word (f·nblk + b)·128 + tid; inactive and full
    sub-blocks are filled with 0 or 0x01 bytes.  A mask byte is read as the
    kernel addresses it: the group's first frame as a 64-bit base, then an
    int offset of at most kGroup frames, a group past the chunk's end
    reading its last frame again."""
    nsuper, nsub, C, BV = pk.shape
    NF, _, H, W = masks.shape
    nblk = nsuper * nsub
    p = pk.reshape(nblk, C, BV // 4, 4).astype(np.int64)
    kind = np.where(active > 0, np.where(full > 0, 2, 1), 0)
    t = min(max(thr, 0), C + 1)
    thr4 = np.uint32(t) * ONES
    full4 = ONES if C >= thr else np.uint32(0)
    flat = masks.reshape(-1)
    cam, frame = H * W, C * H * W
    words = np.zeros((NF, nblk, BV // 4), np.uint32)
    for f0 in range(0, NF, K4_GROUP):
        group = f0 * frame  # the 64-bit base
        for i in range(K4_GROUP):
            fo = (min(f0 + i, NF - 1) - f0) * frame
            w = np.zeros((nblk, BV // 4), np.uint32)
            for c in range(C):
                for e in range(4):
                    row = p[:, c, :, e] >> 10
                    valid = row != tcb.INVALID_ROW
                    x = (((p[:, c, :, e] >> 3) & 127) * 8
                         + (p[:, c, :, e] & 7))
                    off = c * cam + np.where(valid, row * W + x, 0) + fo
                    assert off.max() < K4_GROUP * frame <= 2**31 - 1
                    hit = valid & (flat[group + off] != 0)
                    w += hit.astype(np.uint32) << np.uint32(8 * e)
            if f0 + i >= NF:
                continue  # counted, not stored
            occ_w = _vcmpgeu4(w, thr4) & ONES
            words[f0 + i] = np.where(
                (kind == 1)[:, None], occ_w,
                np.where((kind == 2)[:, None], full4, np.uint32(0)))
    assert (words >> np.uint32(8 * np.arange(4)[:, None, None, None])
            & np.uint32(0xFF)).max() <= 1
    return words.view(np.uint8).reshape(NF, nsuper, nsub, BV)


@pytest.fixture(scope="module")
def three_camera_tables():
    cams_j = jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)[:3]
    cams_t = tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0)[:3]
    return (jcp.build_block_tables(cams_j, jconfig.GridConfig(**GRID), (H, W),
                                   accelerate=False, color_camera=0),
            tcb.build_block_tables(cams_t, tconfig.GridConfig(**GRID), (H, W),
                                   color_camera=0, device="cpu"))


@pytest.mark.parametrize("nf", [1, 5, 9])
@pytest.mark.parametrize("thr", [3, 4])
@pytest.mark.parametrize("cams", [3, 4])
def test_packed_counter_model_matches_plain(carve_rig, three_camera_tables,
                                            cams, thr, nf):
    """(exact) K4's packed per-frame counter word and per-byte threshold
    test, modelled in numpy, equal the plain version."""
    _, tt, _, masks = carve_rig
    if cams == 3:
        tt = three_camera_tables[1]
    chunk = _frames(masks[:, :cams], nf)
    active, full = tcb.chunk_activity(torch.from_numpy(chunk), tt, thr)
    want = tcb.carve_frames_plain(tt.pk, active, full,
                                  torch.from_numpy(chunk),
                                  views_threshold=thr).numpy()
    got = _k4_model(tt.pk.numpy(), active.numpy(), full.numpy(), chunk, thr)
    np.testing.assert_array_equal(got, want)
    # a threshold above the camera count leaves every voxel empty
    assert want.any() == (thr <= cams)


@pytest.mark.parametrize("thr", [-1, 0, 5, 300])
def test_threshold_clamp_matches_plain(carve_rig, thr):
    """(exact) A threshold past C + 1 or below 0, clamped by the launcher
    into a byte, keeps the plain version's result."""
    _, tt, _, masks = carve_rig
    chunk = torch.from_numpy(masks)
    active, full = tcb.chunk_activity(chunk, tt, 4)
    want = tcb.carve_frames_plain(tt.pk, active, full, chunk,
                                  views_threshold=thr).numpy()
    got = _k4_model(tt.pk.numpy(), active.numpy(), full.numpy(), masks, thr)
    np.testing.assert_array_equal(got, want)
    assert want.any() == (thr <= 4)


@pytest.mark.parametrize("nf", [1, 5, 8, 9])
def test_frame_major_stores_cover_each_byte_once(nf):
    """Thread tid's 32-bit word of frame f and sub-block b sits at word
    (f·nblk + b)·128 + tid, byte e = voxel 4·tid + e; the 16-byte fill of a
    sub-block is NF·32 stores, store i at plane i // 32, quad i % 32 of the
    sub-block, spread over the 128 threads (store i from thread i % 128).
    Together they write every output byte exactly once."""
    nblk, BV = 6, tcb.BV
    rng = np.random.default_rng(nf)
    vox = rng.integers(0, 2, (nf, nblk, BV), dtype=np.uint8)
    words = np.zeros(nf * nblk * BV // 4, np.uint32)
    for f in range(nf):
        for b in range(nblk):
            for tid in range(128):
                q = vox[f, b, 4 * tid:4 * tid + 4].astype(np.uint32)
                words[(f * nblk + b) * 128 + tid] = (
                    q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24)
    np.testing.assert_array_equal(words.view(np.uint8).reshape(vox.shape),
                                  vox)
    counted = {1, 4}  # the other sub-blocks are filled
    hits = np.zeros(nf * nblk * BV, np.int64)
    for b in range(nblk):
        if b in counted:
            for f in range(nf):
                for tid in range(128):
                    start = ((f * nblk + b) * 128 + tid) * 4
                    hits[start:start + 4] += 1
            continue
        per_thread = np.zeros(128, np.int64)
        for i in range(nf * 32):
            per_thread[i % 128] += 1
            start = (i // 32 * nblk + b) * BV + (i % 32) * 16
            assert start % 16 == 0
            hits[start:start + 16] += 1
        assert per_thread.max() - per_thread.min() <= 1
    assert (hits == 1).all()


def _k4_variants():
    spec = importlib.util.spec_from_file_location(
        "bench_k4_variants",
        Path(__file__).resolve().parents[1] / "scripts" / "bench_k4_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(_k4_variants().VARIANTS))
def test_k4_departures_edit_the_source_once(name):
    """Every departure that the timing script builds is text edits that each
    match K4's shipped source exactly once; the design is the source."""
    edits = _k4_variants().VARIANTS[name]
    src = tcb.K4.source.read_text()
    edits = edits(src) if callable(edits) else edits
    assert bool(edits) == (not name.startswith("design"))
    for old, new in edits:
        assert src.count(old) == 1 and old != new
        src = src.replace(old, new)
    assert src != tcb.K4.source.read_text() or not edits


def _camera_counts_script():
    spec = importlib.util.spec_from_file_location(
        "bench_camera_counts",
        Path(__file__).resolve().parents[1] / "scripts"
        / "bench_camera_counts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["K1", "K4"])
def test_direct_at_four_cameras_edits_the_launcher_once(name):
    """The camera-count timing script's copy that sends C = 4 to the
    direct kernel is one edit matching the launcher's test of the rig's
    camera count exactly once."""
    old, new = _camera_counts_script().DIRECT_AT_4[name]
    src = getattr(tcb, name).source.read_text()
    assert src.count(old) == 1 and "kStaticC" in old and old != new


def _card_check_case(case, carve_rig, three_camera_tables):
    jt, tt, _, masks = carve_rig
    thr, nf = 4, len(masks)
    if case == "empty":
        masks = np.zeros_like(masks)
    elif case == "full":
        masks = np.full_like(masks, 255)
    elif case == "threshold_3":
        thr = 3
    elif case == "full_in_one_frame":
        masks, nf = masks[3:5], 2  # frame 4 is all foreground
    elif case == "nf_9":
        masks, nf = _frames(masks, 9), 9
    elif case == "three_cameras":
        (jt, tt), masks, thr = three_camera_tables, masks[:, :3], 3
    return jt, tt, np.ascontiguousarray(masks), thr, nf


@pytest.mark.parametrize("case", ["empty", "full", "threshold_3",
                                  "full_in_one_frame", "nf_9",
                                  "three_cameras"])
def test_plain_matches_pallas_on_the_card_check_inputs(
        carve_rig, three_camera_tables, case):
    """(exact) The inputs that hold K4 on the card beyond the production
    chunk: the plain version equals the Pallas kernel in interpret mode."""
    jt, tt, masks, thr, nf = _card_check_case(case, carve_rig,
                                              three_camera_tables)
    got = tcb.carve_frames_blocked(torch.from_numpy(masks), tt,
                                   views_threshold=thr,
                                   frames_per_launch=nf).numpy()
    ref = np.asarray(jcp.carve_frames_blocked(
        jnp.asarray(masks), jt, views_threshold=thr, frames_per_launch=nf,
        interpret=True))
    np.testing.assert_array_equal(got, ref)
    per_frame = got.sum(axis=1)
    if case == "empty":
        assert not per_frame.any()
    else:
        assert per_frame.min() > 0
    if case == "full_in_one_frame":
        assert per_frame[1] > per_frame[0]
    if case == "nf_9":
        np.testing.assert_array_equal(got[5:], got[:4])


# -- the whole offline path, on the rig of tests/test_offline_frames.py ----


def _rig_background():
    """(C, 6, H, W, 3) u8 training frames of the offline rig."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 200, size=(C, 6, H, W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def models():
    mp = tuple(dataclasses.replace(p, figure_threshold=40.0,
                                   inner_threshold=8.0)
               for p in jconfig.DEFAULT_MASK_PARAMS[:C])
    mj = jvh.VisualHull(jsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        jconfig.GridConfig(**GRID),
                        jconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=mp)
    bg = _rig_background()
    mj.bg_states = [jbackground.train_background_model(
        bg[c], jconfig.MOGParams(history=6)) for c in range(C)]
    mj.mog_params = [jconfig.MOGParams(history=6)] * C
    mt = tvh.VisualHull(tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
                        tconfig.GridConfig(**GRID),
                        tconfig.RigConfig(image_height=H, image_width=W),
                        mask_params=[tconfig.MaskParams(
                            **dataclasses.asdict(p)) for p in mp],
                        device="cpu")
    mt.bg_states = [tart.from_numpy_state(s, "cpu") for s in mj.bg_states]
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


@pytest.mark.parametrize("F,nf", [(3, 3), (3, 2), (3, 8)])
def test_offline_result_is_one_owned_row_major_array(models, F, nf):
    """(exact) F a multiple of ``frames_per_launch``, not a multiple (the
    last chunk padded on the device) and below it (one partial chunk): the
    occupancy is one C-contiguous, writable (F, N) bool array that owns its
    memory and shares none with the next call's, each frame and its
    colours equal to the per-frame path; ``padded_frames`` grows by the
    last chunk's padding."""
    _, mt, frames = models
    video = frames[:F]
    t0 = time.perf_counter()
    occ, colors = mt.process_frames_offline(video, frames_per_launch=nf)
    counts, lost = profiling.counted(t0, time.perf_counter())
    assert not lost
    assert counts.get("padded_frames", 0) == (-F) % nf
    assert occ.shape == (F, mt.grid.num_voxels) and occ.dtype == bool
    assert occ.flags.c_contiguous and occ.flags.writeable
    assert occ.flags.owndata and occ.base is None
    again, _ = mt.process_frames_offline(video, frames_per_launch=nf)
    assert not np.shares_memory(occ, again)
    np.testing.assert_array_equal(occ, again)
    assert len(colors) == F
    for f in range(F):
        occ_f, col_f = mt.process_frame(video[f])
        np.testing.assert_array_equal(occ[f], occ_f.numpy())
        idx, col = colors[f]
        np.testing.assert_array_equal(idx, np.flatnonzero(occ[f]))
        np.testing.assert_array_equal(col, col_f.numpy()[idx])
    assert not (occ[0] == occ[1]).all()


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
        mt._stage, torch.from_numpy(frames[:2]), mt._btab, views_threshold=4)
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



def _offline_colors_case(case, frames):
    """(video, frames_per_launch, redone frames) of a colour case on the
    rig's F = 3 frames; the background frame carves no voxel."""
    empty = _rig_background()[:, 0]
    burst = frames[1].copy()
    burst[:, ::2, ::2] = 255
    if case == "padded":
        return frames, 2, set()
    if case == "redone":
        return np.stack([frames[0], burst, frames[2]]), 2, {1}
    if case == "empty_frame":
        return np.stack([frames[0], empty, frames[2]]), 2, set()
    # all at once: a padded last chunk holding a redone frame
    return np.stack([frames[0], empty, frames[2], frames[1], burst]), 3, {4}


@pytest.mark.parametrize("case", ["padded", "redone", "empty_frame",
                                  "counter"])
def test_offline_colors_equal_the_host_gather(models, case, monkeypatch):
    """(exact) The device gather's colours, frame by frame, equal
    ``frame_colors_host`` on the returned occupancy (i64 ascending idx,
    (M, 3) u8 BGR): with the padded last chunk's rows dropped, a redone
    frame's colours from its redo, and a frame with no occupied voxel.
    ``color_voxels`` grows by the voxels of the frames not redone.  The
    chunk's occupancy of an overflowed frame is made wrong (every voxel),
    as the device result of such a frame may be, so that colours taken
    from it would show."""
    _, mt, frames = models
    video, nf, redone = _offline_colors_case(case, frames)
    step = tvh._full_step_frames

    def overflowed_rows_wrong(*a, **k):
        occ, ovf = step(*a, **k)
        return occ | ovf.any(dim=1, keepdim=True), ovf

    monkeypatch.setattr(tvh, "_full_step_frames", overflowed_rows_wrong)
    assert len(video) % nf
    t0 = time.perf_counter()
    occ, colors = mt.process_frames_offline(video, frames_per_launch=nf)
    counts, lost = profiling.counted(t0, time.perf_counter())
    assert not lost and len(colors) == len(video) == len(occ)
    lin_idx = mt.tables.lin_idx.numpy()
    cc = mt.rig.color_camera
    for f, (idx, col) in enumerate(colors):
        want_idx, want_col = tcb.frame_colors_host(occ[f], video[f][cc],
                                                   lin_idx, color_camera=cc)
        assert idx.dtype == np.int64 and col.dtype == np.uint8
        assert idx.shape == want_idx.shape and col.shape == (len(idx), 3)
        assert (np.diff(idx) > 0).all()
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(col, want_col)
    sizes = [len(idx) for idx, _ in colors]
    assert counts.get("redos", 0) == len(redone)
    assert counts.get("color_voxels", 0) == sum(
        n for f, n in enumerate(sizes) if f not in redone)
    for f in redone:
        np.testing.assert_array_equal(
            occ[f], mt.process_frame(video[f])[0].numpy())
    if case in ("empty_frame", "counter"):
        assert sizes[1] == 0 and min(sizes[:1] + sizes[2:]) > 0
    else:
        assert min(sizes) > 0
