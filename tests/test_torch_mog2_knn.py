"""Port parity: the MOG2 and KNN background models, ``raw_masks_batched``
and ``BackgroundPipeline``.

The same seeded frames go through ``vbr_tpu`` and the port on the CPU.
What is compared how:

* MOG2 against ``vbr_tpu`` run op by op (``jax.disable_jit()``): ``weight``,
  ``mean``, ``var``, ``nmodes``, ``nframes`` and the masks are EXACT, on a
  sequence in which modes are pruned and new modes replace the last slot
  of a full pixel.  Against ``vbr_tpu``'s jitted build within ``JIT_ULP``
  units in the last place and ``JIT_MASK_SHARE`` of the mask pixels:
  XLA:CPU contracts ``(1−α)·w + prune`` and the owner updates into fused
  multiply-adds under ``jit``, where ``vbr_tpu``'s formulas, OpenCV and
  the port round twice.
* KNN: ``init_knn``, the first ``n_samples`` frames (a deterministic
  round-robin fill) and ``apply_knn`` on a state carried across are EXACT.
  The later random slot replacement draws from ``jax.random`` in
  ``vbr_tpu`` and from a ``torch.Generator`` in the port, so it is held
  statistically: the share of pixels replaced per frame within 5 binomial
  standard deviations of N/min(n_seen, history), the replaced slot uniform
  over N by a χ² test at p > 1e-4, and the same seed giving the same state.
* ``raw_masks_batched`` and ``BackgroundPipeline.masks_for_frames``: EXACT.
"""

import dataclasses

import numpy as np
import pytest
import scipy.stats
import torch

import jax

from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.pipelines import background as jbackground
from vbr_tpu.utils import artifacts as jart
from vbr_tpu.utils import config as jconfig
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops import gmm as tgmm
from vbr_tpu_torch.pipelines import background as tbackground
from vbr_tpu_torch.utils import config as tconfig

JIT_ULP = 64  # see the module docstring (measured: see the test)
JIT_MASK_SHARE = 0.01
CPU = "cpu"
FIELDS2 = ("weight", "mean", "var", "nmodes", "nframes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(a, b):
    """Largest distance in units in the last place between f32 arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _palette_frames(seed, T=12, H=24, W=32, colours=6, sigma=2.0):
    """T frames in which every pixel shows one of ``colours`` seeded
    colours, drawn anew each frame, plus noise: modes appear, are matched
    again, decay and are pruned."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colours, H, W, 3))
    idx = rng.integers(0, colours, (T, H, W))
    fr = pal[idx, np.arange(H)[None, :, None], np.arange(W)[None, None, :]]
    return np.clip(fr + rng.normal(0, sigma, fr.shape), 0, 255).astype(
        np.uint8)


MOG2_CASES = {
    "default": {},
    "short history, 3 modes": {"history": 4, "n_mixtures": 3},
}


@pytest.fixture(scope="module", params=list(MOG2_CASES))
def mog2_case(request):
    """The sequence, both packages' params, ``vbr_tpu``'s state op by op
    and jitted, and its op-by-op mask of the last frame."""
    kw = MOG2_CASES[request.param]
    frames = _palette_frames(7)
    jp, tp = jgmm.MOG2Params(**kw), tgmm.MOG2Params(**kw)
    with jax.disable_jit():
        js = jgmm.train_mog2(frames, jp)
        jmask = np.asarray(jgmm.extract_mask_mog2(js, frames[-1], jp))
    jj = jgmm.train_mog2(frames, jp)
    return frames, jp, tp, js, jj, jmask


def test_init_mog2_matches():
    jp, tp = jgmm.MOG2Params(), tgmm.MOG2Params()
    js = jgmm.init_mog2((5, 7), jp)
    ts = tgmm.init_mog2((5, 7), tp, device=CPU)
    for f in FIELDS2:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_mog2_matches_reference_op_by_op(mog2_case):
    frames, jp, tp, js, _, jmask = mog2_case
    ts = tgmm.train_mog2(frames, tp, chunk=5, device=CPU)
    for f in FIELDS2:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(
        tgmm.extract_mask_mog2(ts, frames[-1], tp).numpy(), jmask)


def test_mog2_sequence_prunes_and_replaces_on_full_pixels():
    """The short-history case's sequence reaches the update's rare
    branches: a visited mode pruned (the live count falls) and a new mode
    written over the last slot of a pixel whose K modes are all live."""
    frames = _palette_frames(7)
    tp = tgmm.MOG2Params(**MOG2_CASES["short history, 3 modes"])
    K = tp.n_mixtures
    hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(frames))
    st = tgmm.init_mog2(frames.shape[1:3], tp, device=CPU)
    pruned = full_replaced = 0
    for fr in hsv:
        new = tgmm.update_mog2(st, fr, tp)
        x = fr.to(torch.float32)[..., None, :]
        fresh = ((new.mean == x).all(-1).any(-1)
                 & ~(st.mean == x).all(-1).any(-1))
        pruned += int((new.nmodes < st.nmodes).sum())
        full_replaced += int(((st.nmodes == K) & fresh).sum())
        st = new
    assert pruned > 0 and full_replaced > 0, (pruned, full_replaced)


def test_mog2_within_tolerance_of_the_jitted_reference(mog2_case):
    frames, jp, tp, _, jj, _ = mog2_case
    ts = tgmm.train_mog2(frames, tp, device=CPU)
    same_modes = np.asarray(jj.nmodes) == ts.nmodes.numpy()
    assert same_modes.mean() >= 1 - JIT_MASK_SHARE
    sel = same_modes
    for f in ("weight", "var"):
        assert _ulp(np.asarray(getattr(jj, f))[sel],
                    getattr(ts, f).numpy()[sel]) <= JIT_ULP, f
    assert _ulp(np.asarray(jj.mean)[sel],
                ts.mean.numpy()[sel]) <= JIT_ULP
    jm = np.asarray(jgmm.extract_mask_mog2(jj, frames[-1], jp))
    tm = tgmm.extract_mask_mog2(ts, frames[-1], tp).numpy()
    assert (jm != tm).mean() <= JIT_MASK_SHARE


def test_apply_mog2_on_a_carried_state_matches(mog2_case):
    """``vbr_tpu``'s jitted state carried into the port: the frozen apply
    gives ``vbr_tpu``'s mask bit for bit."""
    frames, jp, tp, _, jj, _ = mog2_case
    carried = tgmm.MOG2State(*(torch.from_numpy(np.array(a)) for a in jj))
    rng = np.random.default_rng(1)
    for fr in (frames[0], frames[5], rng.integers(0, 256, frames[0].shape)
               .astype(np.uint8)):
        np.testing.assert_array_equal(
            tgmm.extract_mask_mog2(carried, fr, tp).numpy(),
            np.asarray(jgmm.extract_mask_mog2(jj, fr, jp)))


# -- KNN ------------------------------------------------------------------


def test_init_knn_matches():
    jp, tp = jgmm.KNNParams(), tgmm.KNNParams()
    js = jgmm.init_knn((5, 7), jp)
    ts = tgmm.init_knn((5, 7), tp, device=CPU)
    np.testing.assert_array_equal(ts.samples.numpy(), np.asarray(js.samples))
    assert int(ts.n_seen) == int(js.n_seen) == 0
    assert ts.n_seen.dtype == torch.int32


@pytest.mark.parametrize("n_samples, T", [(21, 12), (21, 21), (4, 4)])
def test_knn_fill_matches(n_samples, T):
    """The first ``n_samples`` frames fill the slots round robin: the
    samples equal ``vbr_tpu``'s bit for bit."""
    frames = _palette_frames(3, T=T)
    jp = jgmm.KNNParams(n_samples=n_samples)
    tp = tgmm.KNNParams(n_samples=n_samples)
    js = jgmm.train_knn(frames, jp)
    ts = tgmm.train_knn(frames, tp, chunk=5, device=CPU)
    np.testing.assert_array_equal(ts.samples.numpy(), np.asarray(js.samples))
    assert int(ts.n_seen) == int(js.n_seen) == T
    np.testing.assert_array_equal(
        tgmm.extract_mask_knn(ts, frames[0], tp).numpy(),
        np.asarray(jgmm.extract_mask_knn(js, frames[0], jp)))


def test_apply_knn_on_a_carried_state_matches():
    """``vbr_tpu``'s state after its random replacements, carried across
    as numpy: ``apply_knn`` gives ``vbr_tpu``'s mask bit for bit."""
    frames = _palette_frames(5, T=30, colours=4)
    jp, tp = jgmm.KNNParams(), tgmm.KNNParams()
    js = jgmm.train_knn(frames, jp)
    carried = tgmm.KNNState(torch.from_numpy(np.asarray(js.samples)),
                            torch.tensor(int(js.n_seen), dtype=torch.int32),
                            torch.Generator())
    rng = np.random.default_rng(2)
    for fr in (frames[-1], rng.integers(0, 256, frames[0].shape)
               .astype(np.uint8)):
        got = tgmm.extract_mask_knn(carried, fr, tp).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jgmm.extract_mask_knn(js, fr, jp)))


def test_knn_replacement_is_binomial_and_uniform():
    """After the fill a pixel replaces a slot with probability
    N/min(n_seen, history), the slot uniform over N: per frame the
    replaced share lies within 5 binomial σ, and the slots pass a χ² test
    at p > 1e-4.  A frame of a colour no sample holds marks the
    replacements."""
    H, W = 64, 80
    tp = tgmm.KNNParams(n_samples=5, history=12, use_hsv=False)
    N = tp.n_samples
    st = tgmm.init_knn((H, W), tp, seed=11, device=CPU)
    for t in range(N):  # the fill, with slot t holding value t
        st = tgmm.update_knn(st, torch.full((H, W, 3), t, dtype=torch.uint8),
                             tp)
    slots = []
    for t in range(N, N + 16):
        n_seen = t + 1
        mark = 100 + t
        new = tgmm.update_knn(st, torch.full((H, W, 3), mark,
                                             dtype=torch.uint8), tp)
        changed = (new.samples != st.samples).any(-1)  # (H, W, N)
        assert int(changed.sum(-1).max()) <= 1
        hit = changed.any(-1)
        p = N / min(n_seen, tp.history)
        n = H * W
        k = int(hit.sum())
        assert abs(k - n * p) <= 5 * np.sqrt(n * p * (1 - p)) + 1e-9, (t, k)
        slots.append(changed[hit].float().argmax(-1))
        st = new
    counts = torch.bincount(torch.cat(slots), minlength=N).numpy()
    assert scipy.stats.chisquare(counts).pvalue > 1e-4, counts


def test_knn_same_seed_same_state():
    frames = _palette_frames(9, T=30, colours=4)
    tp = tgmm.KNNParams(n_samples=4)
    a = tgmm.train_knn(frames, tp, seed=3, device=CPU)
    b = tgmm.train_knn(frames, tp, seed=3, device=CPU)
    c = tgmm.train_knn(frames, tp, seed=4, device=CPU)
    assert torch.equal(a.samples, b.samples)
    assert not torch.equal(a.samples, c.samples)


@pytest.mark.parametrize("entry", ["init_mog2", "init_knn", "train_mog2",
                                   "train_knn"])
def test_mog2_knn_entry_points_default_to_the_card(entry):
    """No fallback to the CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    frames = np.zeros((2, 4, 6, 3), np.uint8)
    call = {
        "init_mog2": lambda: tgmm.init_mog2((4, 6), tgmm.MOG2Params()),
        "init_knn": lambda: tgmm.init_knn((4, 6), tgmm.KNNParams()),
        "train_mog2": lambda: tgmm.train_mog2(frames),
        "train_knn": lambda: tgmm.train_knn(frames),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


# -- raw_masks_batched and BackgroundPipeline ------------------------------


def _seeded_states(seed, C=2, H=20, W=28, K=6):
    """Per-camera MOG states (numpy) whose first slots sit near a seeded
    background, and frames of that background with a dark block."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(60, 200, (C, H, W, 3)).astype(np.uint8)
    hsv = tcolor.bgr_to_hsv_u8(torch.from_numpy(bg)).numpy()
    states = []
    for c in range(C):
        w = np.zeros((H, W, K), np.float32)
        w[..., :3] = rng.dirichlet([6.0, 3.0, 1.0], size=(H, W))
        mean = np.zeros((H, W, K, 3), np.float32)
        mean[..., :3, :] = (hsv[c][:, :, None, :].astype(np.float32)
                            + rng.normal(0, 3, (H, W, 3, 3)))
        var = np.zeros((H, W, K), np.float32)
        var[..., :3] = rng.uniform(100.0, 200.0, (H, W, 3))
        states.append((w, mean, var, np.int32(40 + c)))
    frames = bg.copy()
    frames[:, 5:14, 8:20] = rng.integers(0, 20, (C, 9, 12, 3))
    return states, frames


MASK_PARAMS = [tconfig.MaskParams(20, 4, True, True, True, True),
               tconfig.MaskParams(20, 4, False, True, False, True)]


def test_raw_masks_batched_matches():
    states, frames = _seeded_states(4)
    jst = jbackground.stack_states(
        [jgmm.MOGState(*(jax.numpy.asarray(a) for a in s)) for s in states])
    tst = tbackground.stack_states(
        [tgmm.MOGState(*(torch.from_numpy(np.asarray(a)) for a in s))
         for s in states])
    jmp = tuple(jconfig.MaskParams(**dataclasses.asdict(m))
                for m in MASK_PARAMS)
    want = np.asarray(jbackground.raw_masks_batched(
        jst, jax.numpy.asarray(frames), jmp, jconfig.MOGParams()))
    got = tbackground.raw_masks_batched(tst, torch.from_numpy(frames),
                                        MASK_PARAMS, tconfig.MOGParams())
    assert 0 < (want > 0).mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_background_pipeline_from_a_reference_cache(tmp_path):
    """A cache of ``mog_cam{c}.npz`` written by ``vbr_tpu``: the port's
    pipeline loads it and gives ``vbr_tpu``'s pipeline's masks."""
    states, frames = _seeded_states(5)
    for c, s in enumerate(states, start=1):
        jart.save_mog_state(str(tmp_path / f"mog_cam{c}.npz"),
                            jgmm.MOGState(*s))
    jmp = [jconfig.MaskParams(**dataclasses.asdict(m)) for m in MASK_PARAMS]
    jpipe = jbackground.BackgroundPipeline(
        str(tmp_path / "no_data"), num_cameras=2, mask_params=jmp,
        cache_dir=str(tmp_path))
    tpipe = tbackground.BackgroundPipeline(
        str(tmp_path / "no_data"), num_cameras=2, mask_params=MASK_PARAMS,
        cache_dir=str(tmp_path), device=CPU)
    assert [p.history for p in tpipe.mog_params] == [40, 41]
    want = jpipe.masks_for_frames(frames)
    assert 0 < (want > 0).mean() < 1
    for backend in ("host", "device-xla"):
        np.testing.assert_array_equal(
            tpipe.masks_for_frames(frames, ccl_backend=backend), want)


def test_background_pipeline_from_frames_writes_the_cache(tmp_path):
    """Built from background frames, the pipeline trains each camera
    (history = its frame count), writes the cache, and a second pipeline
    loads it: both give the masks of ``vbr_tpu`` trained on the same
    frames."""
    rng = np.random.default_rng(6)
    bg = rng.integers(60, 200, (2, 16, 24, 3))
    seqs = [np.clip(bg[c] + rng.normal(0, 3, (5, 16, 24, 3)), 0, 255)
            .astype(np.uint8) for c in range(2)]
    frames = np.stack([s[0] for s in seqs])
    frames[:, 4:10, 6:16] = 5
    first = tbackground.BackgroundPipeline(
        None, num_cameras=2, mask_params=MASK_PARAMS, cache_dir=str(tmp_path),
        background_frames=seqs, device=CPU)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "mog_cam1.npz", "mog_cam2.npz"]
    second = tbackground.BackgroundPipeline(
        None, num_cameras=2, mask_params=MASK_PARAMS, cache_dir=str(tmp_path),
        device=CPU)
    assert [p.history for p in first.mog_params] == [5, 5]
    got = first.masks_for_frames(frames)
    np.testing.assert_array_equal(second.masks_for_frames(frames), got)
    jp = jconfig.MOGParams(history=5)
    jmp = [jconfig.MaskParams(**dataclasses.asdict(m)) for m in MASK_PARAMS]
    want = np.stack([np.asarray(jbackground.extract_foreground_mask(
        jgmm.train_mog(seqs[c], jp), frames[c], jmp[c], jp,
        ccl_backend="host")) for c in range(2)])
    assert 0 < (want > 0).mean() < 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cache", [False, True])
def test_background_pipeline_needs_a_cache_or_frames(tmp_path, cache):
    """Neither a cached model, background frames nor a data directory: a
    clear ValueError, and no video is opened."""
    with pytest.raises(ValueError, match="background_frames"):
        tbackground.BackgroundPipeline(
            None, num_cameras=2, cache_dir=str(tmp_path) if cache else None,
            device=CPU)
