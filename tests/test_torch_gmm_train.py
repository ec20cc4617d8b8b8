"""Port parity: MOG background training (``_update_arrays``, the
multi-frame loop behind kernel K3, ``train_mog``).

The same seeded frames go through ``vbr_tpu`` and the port on the CPU
(where the K3 wrapper runs its plain version).  What is compared how:

* Against ``vbr_tpu`` run op by op (``jax.disable_jit()``): ``weight``,
  ``mean``, ``var``, the apply-facing ``MOGState`` and the training masks
  are EXACT.  The stored ``sort_key`` is within 4 ulp: the port computes
  it as OpenCV does, ``w / sqrtf(Σv)`` in IEEE arithmetic, while XLA's
  ``sqrt``/``rsqrt`` on the CPU is not the correctly rounded one.
* Against ``vbr_tpu`` as it compiles on the CPU (``jit``: the XLA scan
  ``_train_chunk`` and the Pallas kernel in interpret mode) within
  ``JIT_ULP`` units in the last place: XLA:CPU contracts ``a + b·c`` into a
  fused multiply-add under ``jit`` (one rounding where ``vbr_tpu``'s
  formulas, OpenCV and the port round twice), which moves ``w + α(1−w)``,
  ``μ + α·diff`` and ``v + α(diff² − v)`` by a few ulp over a chunk
  (measured: at most 6 ulp after 11 frames of the input below).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vbr_tpu.ops import color as jcolor
from vbr_tpu.ops import gmm as jgmm
from vbr_tpu.utils import config as jconfig
from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.ops import color as tcolor
from vbr_tpu_torch.ops import gmm as tgmm
from vbr_tpu_torch.pipelines import background as tbackground
from vbr_tpu_torch.utils import artifacts as tart
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import synthetic as tsyn

JIT_ULP = 16  # see the module docstring
FIELDS = ("weight", "mean", "var")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(**kw):
    return jconfig.MOGParams(**kw), tconfig.MOGParams(**kw)


def _ulp(a, b):
    """Largest distance in units in the last place between f32 arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _assert_states_exact(st_t, st_j, fields=FIELDS):
    for name in fields:
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=name)
    assert int(st_t.nframes) == int(st_j.nframes)


def _anchored_frames(rng, T, H, W, sigma=4.0):
    """Every pixel jumps among 9 well-separated colours (the cube's corners
    and centre, further apart than the match radius) with a little noise:
    modes match, bubble, and at least 8 slots fill."""
    anchors = np.array([[x, y, z] for x in (20, 235) for y in (20, 235)
                        for z in (20, 235)] + [[128, 128, 128]], np.float64)
    pick = rng.integers(0, len(anchors), (T, H, W))
    fr = anchors[pick] + rng.normal(0, sigma, (T, H, W, 3))
    return np.clip(fr, 0, 255).astype(np.uint8)


def test_init_states_match():
    pj, pt = _params(n_mixtures=7)
    for init_j, init_t in ((jgmm.init_state, tgmm.init_state),
                           (jgmm.init_train_state, tgmm.init_train_state)):
        st_j, st_t = init_j((6, 10), pj), init_t((6, 10), pt, "cpu")
        # the port's training state also carries its high-water mark
        extra = ("used",) if init_t is tgmm.init_train_state else ()
        assert st_t._fields == st_j._fields + extra
        for a, b in zip(st_t, st_j):
            assert tuple(a.shape) == b.shape and not a.any()
            assert str(a.dtype).split(".")[1] == str(b.dtype)


@pytest.mark.parametrize("make", ["init_state", "init_train_state",
                                  "from_numpy_state", "train_state_from_numpy",
                                  "stack_frozen", "load_mog_state"])
def test_state_helpers_default_to_the_card(make, tmp_path):
    """Like every entry point, the state helpers build on ``"cuda"`` unless
    told otherwise, and raise without a card (no CPU fallback)."""
    from vbr_tpu_torch.pipelines import background as tbg
    from vbr_tpu_torch.utils.config import MOGParams

    p = MOGParams(n_mixtures=3)
    st = tgmm.init_state((4, 5), p, "cpu")
    path = str(tmp_path / "mog.npz")
    tart.save_mog_state(path, st)
    ts = tgmm.init_train_state((4, 5), p, "cpu")
    call = {"init_state": lambda: tgmm.init_state((4, 5), p),
            "init_train_state": lambda: tgmm.init_train_state((4, 5), p),
            "from_numpy_state": lambda: tart.from_numpy_state(st),
            "train_state_from_numpy": lambda: tart.train_state_from_numpy(
                tart.train_state_to_numpy(ts)),
            "stack_frozen": lambda: tbg.stack_frozen([st], p),
            "load_mog_state": lambda: tart.load_mog_state(path)}[make]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


# -- one chunk, at the JAX package's own test size --------------------------

H0, W0, T0 = 16, 48, 11


@pytest.fixture(scope="module")
def chunk():
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (T0, H0, W0, 3), dtype=np.uint8)
    pj, pt = _params(history=T0, use_hsv=False, n_mixtures=50)
    st_t, masks_t = tgmm._train_chunk(
        tgmm.init_train_state((H0, W0), pt, "cpu"), torch.from_numpy(frames),
        pt, True)
    return frames, pj, pt, st_t, masks_t


def test_train_chunk_exact_against_op_by_op(chunk):
    frames, pj, _, st_t, masks_t = chunk
    with jax.disable_jit():
        st_j, masks_j = jgmm._train_chunk(
            jgmm.init_train_state((H0, W0), pj), jnp.asarray(frames), pj,
            True)
    _assert_states_exact(st_t, st_j)
    assert _ulp(st_t.sort_key.numpy(), st_j.sort_key) <= 4
    np.testing.assert_array_equal(masks_t.numpy(), np.asarray(masks_j))
    assert 0 < masks_t.numpy().mean() < 255


@pytest.mark.parametrize("ref", ["xla_scan", "pallas_interpret"])
def test_train_chunk_against_compiled(chunk, ref):
    frames, pj, _, st_t, _ = chunk
    st0 = jgmm.init_train_state((H0, W0), pj)
    if ref == "xla_scan":
        st_j, _ = jgmm._train_chunk(st0, jnp.asarray(frames), pj, False)
    else:
        st_j = jgmm._train_chunk_pallas(st0, jnp.asarray(frames), pj,
                                        interpret=True)
    for name in FIELDS + ("sort_key",):
        assert _ulp(getattr(st_t, name).numpy(),
                    getattr(st_j, name)) <= JIT_ULP, name
    assert int(st_t.nframes) == int(st_j.nframes) == T0


def test_k3_wrapper_uses_plain_on_cpu_only(chunk):
    frames, _, pt, st_t, _ = chunk
    before = tgmm.K3.launches
    st0 = tgmm.init_train_state((H0, W0), pt, "cpu")
    got = tgmm.train_chunk_kernel(st0, torch.from_numpy(frames), pt)
    for name in FIELDS + ("sort_key", "nframes"):
        assert torch.equal(getattr(got, name), getattr(st_t, name)), name
    assert tgmm.K3.launches == before
    assert not st0.weight.any()  # the plain version allocates new arrays
    assert "-fmad=false" in tgmm.K3.flags
    meta = tgmm.MOGTrainState(*(a.to("meta") for a in st0))
    with pytest.raises(ValueError, match="no kernel"):
        tgmm.train_chunk_kernel(meta, torch.from_numpy(frames).to("meta"),
                                pt)


def test_kernel_library_named_by_source_and_flags():
    """A changed ``nvcc`` flag must not load a library built without it."""
    from vbr_tpu_torch.ops._cuda import CudaKernel

    plain = CudaKernel("mog_train.cu", "vbr_mog_train", [])
    nofma = CudaKernel("mog_train.cu", "vbr_mog_train", [],
                       extra_flags=("-fmad=false",))
    assert plain.lib_path != nofma.lib_path == tgmm.K3.lib_path
    assert nofma.lib_path.name.startswith("libmog_train_")


# -- train_mog across chunk boundaries ---------------------------------------


@pytest.mark.parametrize("use_hsv", [False, True])
def test_train_mog_across_chunks(use_hsv):
    rng = np.random.default_rng(8)
    frames = _anchored_frames(rng, 21, 8, 32)
    pj, pt = _params(history=21, use_hsv=use_hsv, n_mixtures=10)
    with jax.disable_jit():
        st_j, masks_j = jgmm.train_mog(frames, pj, chunk=8,
                                       return_masks=True, backend="xla")
    st_t = tgmm.train_mog(frames, pt, chunk=8, device="cpu")
    _assert_states_exact(st_t, st_j)
    if not use_hsv:  # Σw runs over many filled slots
        assert int((st_t.weight > 0).sum(dim=-1).max()) >= 8
    st_m, masks_t = tgmm.train_mog(frames, pt, chunk=8, return_masks=True,
                                   device="cpu")
    _assert_states_exact(st_m, st_j)
    assert masks_t.shape == (21, 8, 32) and masks_t.dtype == np.uint8
    np.testing.assert_array_equal(masks_t, masks_j)
    probe = np.clip(frames[-1].astype(np.int32) + 60, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(
        tgmm.extract_mask(st_t, probe, pt).numpy(),
        np.asarray(jgmm.extract_mask(st_j, probe, pj)))


def test_train_mog_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgmm.train_mog(np.zeros((1, 8, 8, 3), np.uint8))


def test_mid_training_state_carried_across():
    """Both packages go on from one mid-training state whose ``nframes``
    is past ``history`` (so α sits at its 1/history clamp)."""
    rng = np.random.default_rng(9)
    H, W = 8, 32
    frames = _anchored_frames(rng, 15, H, W)
    pj, pt = _params(history=5, use_hsv=False, n_mixtures=10)
    mid_j, _ = jgmm._train_chunk(jgmm.init_train_state((H, W), pj),
                                 jnp.asarray(frames[:9]), pj, False)
    mid_np = jgmm.MOGTrainState(*(np.asarray(a) for a in mid_j))
    assert int(mid_np.nframes) == 9 > pj.history
    mid_t = tart.train_state_from_numpy(mid_np, "cpu")
    back = tart.train_state_to_numpy(mid_t)
    for name in mid_np._fields:
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(mid_np, name))
    with jax.disable_jit():
        end_j, _ = jgmm._train_chunk(
            jgmm.MOGTrainState(*(jnp.asarray(a) for a in mid_np)),
            jnp.asarray(frames[9:]), pj, False)
    end_t = tgmm.train_chunk_kernel(mid_t, torch.from_numpy(frames[9:]), pt)
    _assert_states_exact(end_t, end_j)
    assert _ulp(end_t.sort_key.numpy(), end_j.sort_key) <= 4
    assert int(end_t.nframes) == 15
    fin_t = tgmm.finalize_train_state(end_t, (H, W), pt)
    fin_j = jgmm.finalize_train_state(end_j, (H, W), pj)
    _assert_states_exact(fin_t, fin_j)


def test_trained_state_compresses_alike():
    """A state trained by each package gives the same prefix length Ke,
    per-pixel bounds and frozen masks."""
    rng = np.random.default_rng(10)
    H, W = 8, 32
    bg = rng.integers(30, 220, (H, W, 3))
    frames = np.clip(bg + rng.normal(0, 5, (16, H, W, 3)), 0,
                     255).astype(np.uint8)
    frames[6:10, 2:6] = rng.integers(0, 256, (4, 4, W, 3))  # a passer-by
    pj, pt = _params(history=16, n_mixtures=10)
    with jax.disable_jit():
        st_j = jgmm.train_mog(frames, pj, chunk=16, backend="xla")
    st_t = tgmm.train_mog(frames, pt, chunk=16, device="cpu")
    _assert_states_exact(st_t, st_j)
    fz_j, ke_j = jgmm.compress_frozen(st_j, pj)
    fz_t, ke_t = tgmm.compress_frozen(st_t, pt)
    assert ke_t == ke_j
    np.testing.assert_array_equal(fz_t.bcount.numpy(),
                                  np.asarray(fz_j.bcount))
    probe = frames[-1].copy()
    probe[2:7, 8:20] = 255 - probe[2:7, 8:20]
    m_j = np.asarray(jgmm.apply_frozen_compressed(
        fz_j, jcolor.bgr_to_hsv_u8(jnp.asarray(probe))))
    m_t = tgmm.apply_frozen_compressed(
        fz_t, tcolor.bgr_to_hsv_u8(torch.from_numpy(probe))).numpy()
    np.testing.assert_array_equal(m_t, m_j)
    assert 0 < (m_t > 0).mean() < 1


# -- the model's entry point -------------------------------------------------


def test_train_background_and_round_trip(tmp_path):
    H, W, C = 24, 32, 4
    rng = np.random.default_rng(12)
    seqs = [np.clip(rng.integers(40, 200, (H, W, 3))
                    + rng.normal(0, 4, (5 + c, H, W, 3)), 0,
                    255).astype(np.uint8) for c in range(C)]
    rig = tconfig.RigConfig(image_height=H, image_width=W)
    cams = tsyn.synthetic_cameras(C, image_hw=(H, W), f=40.0)
    model = tvh.VisualHull(cams, tconfig.GridConfig(nx=8, ny=8, nz=8), rig,
                           device="cpu")
    model.train_background(seqs)
    assert [p.history for p in model.mog_params] == [5, 6, 7, 8]
    assert [int(s.nframes) for s in model.bg_states] == [5, 6, 7, 8]
    want = tbackground.train_background_model(
        seqs[2], tconfig.MOGParams(history=7), device="cpu")
    stacked = tbackground.stack_states(model.bg_states)
    assert stacked.weight.shape == (C, H, W, 50)
    assert stacked.nframes.tolist() == [5, 6, 7, 8]
    for name in FIELDS:
        assert torch.equal(getattr(stacked, name)[2], getattr(want, name))
    with jax.disable_jit():
        ref = jgmm.train_mog(seqs[0][:, :8], jconfig.MOGParams(history=5))
    np.testing.assert_array_equal(model.bg_states[0].weight[:8].numpy(),
                                  np.asarray(ref.weight))
    model.save_background_models(str(tmp_path))
    m2 = tvh.VisualHull(cams, model.grid, rig, device="cpu")
    assert m2.load_background_models(str(tmp_path))
    for a, b in zip(m2.bg_states, model.bg_states):
        for name in FIELDS + ("nframes",):
            assert torch.equal(getattr(a, name), getattr(b, name))
    with pytest.raises(ValueError, match="background sequences"):
        model.train_background(seqs[:2])


# -- the kernel's design, as far as the CPU can hold it ------------------------
#
# K3 keeps a pixel's slots below a cap S in shared memory for a whole chunk
# and the others in device memory, finds the slots in use through a mark
# ``used`` that travels with the state, and never looks past it.  The model
# below is the kernel's own sequential loop (``csrc/mog_train.cu``) in
# numpy float32 scalars over two arrays, ``near`` (slots < S, what shared
# memory holds) and ``far`` (the state in device memory).


def _torch_sqrt(v):
    """sqrt as the plain version takes it on this host.  PyTorch's CPU
    sqrt need not be the correctly rounded one that numpy and the card's
    ``sqrtf`` give (a build with AVX-512 returns 48.631264 for 2365.0,
    which rounds correctly to 48.631268), so the model borrows it."""
    return torch.sqrt(torch.tensor([v], dtype=torch.float32)).numpy()[0]


def _kernel_model(state, frames, params, S):
    """(state arrays after the chunk, carried mark, slots that a bubble
    moved across the S boundary).  ``near`` starts as NaN and ``far`` is
    poisoned with NaN below min(used, S) once loaded, so a read of what
    the kernel would not hold there shows in the result."""
    f32 = np.float32
    w, key = state.weight.numpy().copy(), state.sort_key.numpy().copy()
    mu, var = state.mean.numpy().copy(), state.var.numpy().copy()
    K, P = w.shape
    S = min(S, K)
    used_all = (state.used if state.used is not None else
                tgmm.slot_high_water(state.weight, state.sort_key)).numpy()
    used_all = used_all.copy()
    far = [w, key, mu[0], mu[1], mu[2], var[0], var[1], var[2]]
    eps, w0 = f32(tgmm.FLT_EPSILON), f32(tgmm.INITIAL_WEIGHT)
    var0 = f32(4.0 * tgmm.DEFAULT_NOISE_SIGMA**2)
    sk0 = f32(tgmm.INITIAL_WEIGHT / (2.0 * tgmm.DEFAULT_NOISE_SIGMA))
    vt, min_var = f32(params.match_sigma**2), f32(params.noise_sigma**2)
    nf0 = int(state.nframes)
    T = frames.shape[0]
    xs = frames.reshape(T, P, 3).astype(f32)
    crossings = 0
    for pix in range(P):
        used = int(used_all[pix])
        near = np.full((8, S), np.nan, f32)
        for k in range(min(used, S)):
            for f in range(8):
                near[f, k] = far[f][k, pix]
                far[f][k, pix] = np.nan

        def get(f, k):
            return near[f, k] if k < S else far[f][k, pix]

        def put(f, k, v):
            if k < S:
                near[f, k] = v
            else:
                far[f][k, pix] = v

        for t in range(T):
            x = xs[t, pix]
            alpha = f32(1.0) / f32(min(nf0 + t + 1, params.history))
            c, k = -1, 0
            while k < used:
                wk = get(0, k)
                if wk < eps:
                    break
                m = [get(2 + i, k) for i in range(3)]
                v = [get(5 + i, k) for i in range(3)]
                d = [x[i] - m[i] for i in range(3)]
                dist2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
                varsum = (v[0] + v[1]) + v[2]
                if dist2 < vt * varsum:
                    c = k
                    break
                k += 1
            if c >= 0:
                wn = wk + alpha * (f32(1.0) - wk)
                kn = wn / _torch_sqrt(varsum)
                p = 0
                for j in range(c - 1, -1, -1):
                    if get(1, j) >= kn:
                        p = j + 1
                        break
                for j in range(c, p, -1):
                    crossings += j == S
                    for f in range(8):
                        put(f, j, get(f, j - 1))
                put(0, p, wn)
                put(1, p, kn)
                for i in range(3):
                    put(2 + i, p, m[i] + alpha * d[i])
                    put(5 + i, p, max(v[i] + alpha * (d[i] * d[i] - v[i]),
                                      min_var))
            else:
                r = min(k, K - 1)
                put(0, r, w0)
                put(1, r, sk0)
                for i in range(3):
                    put(2 + i, r, x[i])
                    put(5 + i, r, var0)
                used = max(used, r + 1)
            total = get(0, 0)
            for j in range(1, used):
                total = total + get(0, j)
            scale = f32(1.0) / total
            for j in range(used):
                put(0, j, get(0, j) * scale)
                put(1, j, get(1, j) * scale)
        for k in range(min(used, S)):
            for f in range(8):
                far[f][k, pix] = near[f, k]
        used_all[pix] = used
    return (w, key, mu, var), used_all, crossings


def _design_case(K, start, seed=21):
    """(state, two chunks of frames, params) at a tiny size: from zeros,
    from a mid-training state, and from one handed over without its mark."""
    rng = np.random.default_rng(seed)
    H, W = 3, 8
    _, pt = _params(history=9, use_hsv=False, n_mixtures=K)
    frames = _anchored_frames(rng, 18, H, W)
    state = tgmm.init_train_state((H, W), pt, "cpu")
    if start != "zeros":
        warm = torch.from_numpy(_anchored_frames(rng, 7, H, W))
        state = tgmm.train_chunk_plain(state, warm, pt)
        assert state.used is None  # the plain version keeps no mark
        if start == "mid":
            state = state._replace(used=tgmm.slot_high_water(
                state.weight, state.sort_key))
    return state, (frames[:11], frames[11:]), pt


@pytest.mark.parametrize("start", ["zeros", "mid", "no_mark"])
@pytest.mark.parametrize("K", [1, 3, 50])
def test_carried_mark_equals_recomputed(K, start):
    """After every chunk the mark that the kernel's loop carries equals
    the one recomputed from the plain version's state, and the state
    itself is the plain version's, bit for bit."""
    state, chunks, pt = _design_case(K, start)
    for frames in chunks:
        want = tgmm.train_chunk_plain(state, torch.from_numpy(frames), pt)
        arrays, used, _ = _kernel_model(state, frames, pt, S=2)
        mark = tgmm.slot_high_water(want.weight, want.sort_key)
        np.testing.assert_array_equal(used, mark.numpy())
        assert mark.dtype == torch.int32 and int(mark.max()) == min(
            K, int(mark.max()))
        for got, name in zip(arrays, ("weight", "sort_key", "mean", "var")):
            np.testing.assert_array_equal(got, getattr(want, name).numpy(),
                                          err_msg=name)
        state = want._replace(used=torch.from_numpy(used))
    assert int(state.nframes) == (18 if start == "zeros" else 25)
    if K == 50:
        assert int(state.used.max()) >= 8  # the 9 anchors fill their slots


@pytest.mark.parametrize("S", [1, 2, 8])
def test_two_residences_equal_plain(S):
    """Slots below S in one array, the others in a second: the same bits
    as the plain version, with slots that a bubble carries across the S
    boundary."""
    rng = np.random.default_rng(22 + S)
    H, W = 4, 12
    _, pt = _params(history=30, use_hsv=False, n_mixtures=50)
    state = tgmm.init_train_state((H, W), pt, "cpu")
    frames = _anchored_frames(rng, 48, H, W)
    want = tgmm.train_chunk_plain(state, torch.from_numpy(frames), pt)
    arrays, used, crossings = _kernel_model(state, frames, pt, S)
    assert crossings > 0
    assert int(used.max()) > S
    for got, name in zip(arrays, ("weight", "sort_key", "mean", "var")):
        np.testing.assert_array_equal(got, getattr(want, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(
        used, tgmm.slot_high_water(want.weight, want.sort_key).numpy())


@pytest.mark.parametrize("with_mark", [True, False])
def test_train_state_round_trip_and_five_arrays(with_mark):
    """The JAX package's training state goes into the port (which adds the
    mark) and back (which drops it); five arrays still make a state."""
    rng = np.random.default_rng(23)
    H, W = 4, 16
    pj, pt = _params(history=6, use_hsv=False, n_mixtures=5)
    mid_j, _ = jgmm._train_chunk(jgmm.init_train_state((H, W), pj),
                                 jnp.asarray(_anchored_frames(rng, 6, H, W)),
                                 pj, False)
    mid_np = jgmm.MOGTrainState(*(np.asarray(a) for a in mid_j))
    mid_t = tart.train_state_from_numpy(mid_np, "cpu")
    assert torch.equal(mid_t.used, tgmm.slot_high_water(mid_t.weight,
                                                        mid_t.sort_key))
    assert 1 <= int(mid_t.used.min()) and int(mid_t.used.max()) <= 5
    if not with_mark:
        mid_t = tgmm.MOGTrainState(*mid_t[:5])
        assert mid_t.used is None
    back = tart.train_state_to_numpy(mid_t)
    assert set(vars(back)) == set(mid_np._fields)
    again = jgmm.MOGTrainState(**vars(back))
    for a, b in zip(again, mid_np):
        np.testing.assert_array_equal(a, b)
    frames = torch.from_numpy(_anchored_frames(rng, 3, H, W))
    end = tgmm.train_chunk_kernel(mid_t, frames, pt)  # plain on the CPU
    assert end.used is None and int(end.nframes) == 9
