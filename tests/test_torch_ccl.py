"""Port parity: combined-phase (K2) and single-phase (K5) labelling and
the mask cleanup.

``vbr_tpu``'s Pallas labeller runs in interpret mode; the port runs its
plain version on the CPU.  Labels, cleaned masks and overflow bits are
compared exactly, including where the iteration cap cuts the fixpoint
short and where small table caps force the overflow bits.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from vbr_tpu.ops import ccl as jccl
from vbr_tpu.ops import ccl_pallas as jcclp
from vbr_tpu_torch.ops import ccl as tccl
from vbr_tpu_torch.ops import ccl_label as tlab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy_mask(rng, H=96, W=128):
    """A figure + speckle noise + holes, like a raw MOG mask."""
    m = np.zeros((H, W), np.uint8)
    m[20:80, 30:90] = 255
    m[40:52, 50:62] = 0  # big hole
    m[28:31, 40:43] = 0  # small hole
    for _ in range(40):
        y, x = rng.integers(0, H), rng.integers(0, W)
        m[y:y + 2, x:x + 2] = 255
    return m


def _spiral(H=32, W=128):
    """A 1-px square spiral corridor: one component needing ~one
    iteration per turn, so a low cap stops the fixpoint early."""
    m = np.zeros((H, W), np.int32)
    y, x = 1, 1
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    for i in range(4 * max(H, W)):
        k = i // 2
        n = (W - 3 - 2 * max(k - 1, 0)) if i % 2 == 0 else (H - 3 - 2 * k)
        if n <= 0:
            break
        dy, dx = steps[i % 4]
        for _ in range(n):
            m[y, x] = 1
            y, x = y + dy, x + dx
    m[y, x] = 1
    return m


def _labels_both(phase, max_iters):
    ref = np.asarray(jcclp.label_components_combined(
        jnp.asarray(phase), max_iters=max_iters, interpret=True))
    got, iters = tlab.label_components_combined(torch.from_numpy(phase),
                                                max_iters=max_iters)
    return ref, got.numpy(), iters.numpy()


def test_labels_match_pallas():
    rng = np.random.default_rng(3)
    phase = (np.stack([_noisy_mask(rng) for _ in range(2)]) > 0)
    ref, got, iters = _labels_both(phase.astype(np.int32), 64)
    np.testing.assert_array_equal(got, ref)
    assert (iters < 64).all()  # converged before the cap


def test_labels_match_pallas_at_the_cap():
    spiral = _spiral()[None]
    assert ndimage.label(spiral[0], np.ones((3, 3)))[1] == 1
    ref, got, iters = _labels_both(spiral, 4)
    np.testing.assert_array_equal(got, ref)
    assert iters.tolist() == [4]
    full, _ = tlab.label_components_combined(torch.from_numpy(spiral), 256)
    assert (full.numpy() != got).any()  # the cap changed the labels
    fg = spiral[0] > 0
    assert (full.numpy()[0][fg] == np.flatnonzero(fg.ravel())[0]).all()


def test_checkerboard_single_pixel_segments():
    yy, xx = np.mgrid[:8, :128]
    ph = ((yy + xx) % 2).astype(np.int32)[None]
    ref, got, _ = _labels_both(ph, 12)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_clean_masks_batched_matches(seed):
    rng = np.random.default_rng(seed)
    raw = np.stack([_noisy_mask(rng) for _ in range(3)])
    fig, inner = (900.0, 1200.0, 600.0), (40.0, 80.0, 20.0)
    out_j, ovf_j = jccl.clean_masks_batched(jnp.asarray(raw), fig, inner,
                                            interpret=True)
    out_t, ovf_t = tccl.clean_masks_batched(torch.from_numpy(raw), fig,
                                            inner)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ovf_t.numpy(), np.asarray(ovf_j))
    assert not ovf_t.numpy().any()
    for c in range(3):
        np.testing.assert_array_equal(
            out_t.numpy()[c], tccl.clean_mask_host(raw[c], fig[c], inner[c]))


def _speckle(H=64, W=128):
    yy, xx = np.mgrid[:H, :W]
    return (((yy % 3 == 0) & (xx % 3 == 0)) * 255).astype(np.uint8)


def _comb(H=32, W=128):
    raw = np.zeros((H, W), np.uint8)
    raw[:, ::4] = 255  # 32 fg + 32 bg runs per row
    raw[-4:, :] = 255
    return raw


@pytest.mark.parametrize("case", ["components", "runs", "holes"])
def test_clean_masks_batched_overflow_matches(case):
    """Small caps force each overflow path; the truncated device result
    and the bits equal the JAX package's, and the host cleanup is exact."""
    if case == "components":
        raw, fig, inner, caps = _speckle(), 5.0, 2.0, dict(kf=64, kb=32)
    elif case == "runs":
        raw, fig, inner, caps = _comb(), 50.0, 10.0, dict(k_runs=16)
    else:  # many holes in one figure: kb/k_hole overflow
        raw = np.zeros((64, 128), np.uint8)
        raw[4:60, 4:124] = 255
        raw[8:56:4, 8:120:4] = 0
        fig, inner, caps = 50.0, 3.0, dict(kb=16)
    out_j, ovf_j = jccl.clean_masks_batched(
        jnp.asarray(raw[None]), (fig,), (inner,), interpret=True, **caps)
    out_t, ovf_t = tccl.clean_masks_batched(
        torch.from_numpy(raw[None]), (fig,), (inner,), **caps)
    assert bool(ovf_t.numpy()[0]) and bool(np.asarray(ovf_j)[0])
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(tccl.clean_mask_host(raw, fig, inner),
                                  jccl.clean_mask_host(raw, fig, inner))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clean_mask_host_matches_cv2(seed):
    rng = np.random.default_rng(100 + seed)
    raw = _noisy_mask(rng)
    # random blobs and pepper: holes of every size, border contact
    for _ in range(30):
        y, x = rng.integers(0, 96), rng.integers(0, 128)
        r = rng.integers(1, 6)
        raw[max(y - r, 0):y + r, max(x - r, 0):x + r] = rng.choice([0, 255])
    raw[rng.random(raw.shape) < 0.02] ^= 255
    for fig, inner in ((5.0, 2.0), (200.0, 9.0), (900.0, 40.0)):
        np.testing.assert_array_equal(
            tccl.clean_mask_host(raw, fig, inner),
            jccl.clean_mask_host(raw, fig, inner))


def _single_both(fg, max_iters):
    ref = np.asarray(jcclp.label_components_batched(
        jnp.asarray(fg), max_iters=max_iters, interpret=True))
    got, iters = tlab.label_components_batched(torch.from_numpy(fg),
                                               max_iters=max_iters)
    return ref, got.numpy(), iters.numpy()


@pytest.mark.parametrize("density", [0.3, 0.55])
def test_single_phase_labels_match_pallas(density):
    """K5 on random masks, sparse (many small components) and near the
    8-connected percolation threshold (long winding ones)."""
    rng = np.random.default_rng(int(density * 100))
    fg = (rng.random((2, 32, 128)) < density).astype(np.int32)
    ref, got, iters = _single_both(fg, 64)
    np.testing.assert_array_equal(got, ref)
    assert (got[fg == 0] == tlab.BIG).all() and (got[fg > 0] < 32 * 128).all()
    assert (iters < 64).all() and (iters >= 2).all()
    lab, n = ndimage.label(fg[0], np.ones((3, 3)))
    assert len(np.unique(got[0][fg[0] > 0])) == n


def _serpentine(H=144, W=128):
    """Every other row joined alternately at its right and left end: one
    component that the fixpoint walks about one row per iteration."""
    m = np.zeros((H, W), np.int32)
    m[::2] = 1
    m[1::4, W - 1] = 1
    m[3::4, 0] = 1
    return m


def test_single_phase_labels_match_pallas_at_the_cap():
    """A serpentine needing more than 64 iterations: equal at the cap,
    where converged labels would differ."""
    fg = _serpentine()[None]
    assert ndimage.label(fg[0], np.ones((3, 3)))[1] == 1
    ref, got, iters = _single_both(fg, 64)
    np.testing.assert_array_equal(got, ref)
    assert iters.tolist() == [64]
    full, it_full = tlab.label_components_batched(torch.from_numpy(fg), 512)
    assert 64 < int(it_full[0]) < 512
    assert (full.numpy() != got).any()
    assert (full.numpy()[0][fg[0] > 0] == 0).all()


@pytest.mark.parametrize("value", [0, 1])
def test_single_phase_empty_and_full_image(value):
    fg = np.full((1, 8, 128), value, np.int32)
    ref, got, iters = _single_both(fg, 64)
    np.testing.assert_array_equal(got, ref)
    assert (got == (0 if value else tlab.BIG)).all()
    assert iters.tolist() == [2 if value else 1]


def test_label_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        tlab.label_components_combined(
            torch.zeros((1, 8, 128), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="multiples"):
        tlab.label_components_combined(torch.zeros((1, 8, 100)))
    with pytest.raises(ValueError, match="no kernel"):
        tlab.label_components_batched(
            torch.zeros((1, 8, 128), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="multiples"):
        tlab.label_components_batched(torch.zeros((1, 8, 100)))
    before = tlab.K5.launches
    tlab.label_components_batched(torch.ones((1, 8, 128)))
    assert tlab.K5.launches == before
