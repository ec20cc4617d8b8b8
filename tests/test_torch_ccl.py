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


# -- the banded, one-buffer scheme of the kernels' cluster route -------------
#
# The CUDA kernels cannot run without a card, so the decomposition they use
# (csrc/ccl_common.cuh) is modelled here in numpy and held against the plain
# versions: an image cut into bands of whole rows; a neighbour pass in place,
# in groups of pixels, with the old tail of each group saved for the next
# and the neighbouring bands' old edge rows in halo rows; row scans; column
# scans as local band scan -> per-column band summaries -> carry fold ->
# apply to the leading segment; "changed" as the OR of "a pass lowered a
# value".  ``rule`` is "phase" (K2: diagonals of equal phase, segments of
# equal phase) or "fg" (K5: all 8 neighbours, segments of foreground).

def _same(rule, a, b):
    return (a == b) if rule == "phase" else ((a & b) == 1)


def _model_init(ph, rule):
    H, W = ph.shape
    lin = np.arange(H * W, dtype=np.int64).reshape(H, W)
    return lin if rule == "phase" else np.where(ph > 0, lin, tlab.BIG)


def _model_neighbour_band(band, top, bottom, ph_band, ph_top, ph_bottom,
                          rule, group):
    """One band's neighbour pass in place: ``band`` (R, W) labels, ``top``
    / ``bottom`` (W,) old edge rows of the neighbouring bands (BIG outside
    the image), phases likewise.  Returns (band, lowered)."""
    R, W = band.shape
    npix = R * W
    lab = np.concatenate([top, band.ravel(), bottom])  # halo, band, halo
    php = np.concatenate([ph_top, ph_band.ravel(), ph_bottom])
    off = W  # lab[off + i] is pixel i of the band
    lowered = False
    saved = None  # old values of the W + 1 pixels before the group
    for gs in range(0, npix, group):
        ge = min(gs + group, npix)
        save_next = lab[off + ge - W - 1:off + ge].copy() if ge < npix else None

        def old(idx):
            if saved is not None and idx < gs:
                return saved[idx - gs + W + 1]
            return lab[off + idx]

        res = np.empty(ge - gs, np.int64)
        for i in range(gs, ge):
            x = i % W
            m = lab[off + i]
            p = php[off + i]
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if (dy, dx) == (0, 0) or not 0 <= x + dx < W:
                        continue
                    j = i + dy * W + dx
                    if rule == "phase":
                        if dy == 0 or dx == 0 or php[off + j] != p:
                            continue
                    elif not p:
                        continue
                    m = min(m, old(j))
            res[i - gs] = m
        lowered |= bool((res < lab[off + gs:off + ge]).any())
        assert (res <= lab[off + gs:off + ge]).all()
        lab[off + gs:off + ge] = res  # after the barrier
        saved = save_next
    return lab[off:off + npix].reshape(R, W), lowered


def _model_row_scans(v, ph, rule):
    """Forward then reverse sequential segmented min along the rows."""
    H, W = v.shape
    out = v.copy()
    for xs, step in ((range(1, W), -1), (range(W - 2, -1, -1), 1)):
        for x in xs:
            cont = _same(rule, ph[:, x + step], ph[:, x])
            out[:, x] = np.where(cont, np.minimum(out[:, x], out[:, x + step]),
                                 out[:, x])
    return out


def _model_col_scan_banded(v, ph, rule, band, reverse):
    """Segmented min-scan down (or up) the columns of ``v`` (H, W), cut
    into bands of ``band`` rows: local scan, summaries, fold, apply."""
    if reverse:
        return _model_col_scan_banded(v[::-1], ph[::-1], rule, band,
                                      False)[::-1]
    H, W = v.shape
    out = v.copy()
    starts = list(range(0, H, band))
    exits, passes = [], []
    for b, r0 in enumerate(starts):
        r1 = min(r0 + band, H)
        run = out[r0].copy()
        whole = np.ones(W, bool)
        for y in range(r0 + 1, r1):
            cont = _same(rule, ph[y - 1], ph[y])
            run = np.where(cont, np.minimum(run, out[y]), out[y])
            out[y] = run
            whole &= cont
        seam = _same(rule, ph[r0 - 1], ph[r0]) if b else np.zeros(W, bool)
        exits.append(run)
        passes.append(whole & seam)  # the carry passes through this band
    for b, r0 in enumerate(starts):
        if b == 0:
            continue
        r1 = min(r0 + band, H)
        k = b - 1
        carry, more = exits[k].copy(), passes[k].copy()
        while more.any():
            k -= 1
            carry = np.where(more, np.minimum(carry, exits[k]), carry)
            more &= passes[k]
        lead = _same(rule, ph[r0 - 1], ph[r0])
        for y in range(r0, r1):
            if y > r0:
                lead = lead & _same(rule, ph[y - 1], ph[y])
            out[y] = np.where(lead, np.minimum(out[y], carry), out[y])
    return out


def _model_iteration(labels, ph, rule, band, group):
    """One iteration of the banded scheme; returns (labels, lowered)."""
    H, W = labels.shape
    big = np.full(W, tlab.BIG, np.int64)
    zero = np.zeros(W, ph.dtype)
    out = np.empty_like(labels)
    lowered = False
    for r0 in range(0, H, band):  # halos hold iteration-start rows
        r1 = min(r0 + band, H)
        out[r0:r1], low = _model_neighbour_band(
            labels[r0:r1].copy(),
            labels[r0 - 1] if r0 else big, labels[r1] if r1 < H else big,
            ph[r0:r1], ph[r0 - 1] if r0 else zero, ph[r1] if r1 < H else zero,
            rule, group)
        lowered |= low
    for step in (lambda v: _model_row_scans(v, ph, rule),
                 lambda v: _model_col_scan_banded(v, ph, rule, band, False),
                 lambda v: _model_col_scan_banded(v, ph, rule, band, True)):
        nxt = step(out)
        assert (nxt <= out).all()  # every pass only lowers
        lowered |= bool((nxt < out).any())
        out = nxt
    return out, lowered


def _model_label(ph, rule, band, group, max_iters):
    labels = _model_init(ph, rule)
    it, changed = 0, True
    while changed and it < max_iters:
        labels, changed = _model_iteration(labels, ph, rule, band, group)
        it += 1
    return labels, it


def _plain(ph, rule, max_iters):
    fn = (tlab.label_components_combined_plain if rule == "phase"
          else tlab.label_components_batched_plain)
    labels, iters = fn(torch.from_numpy(ph[None].astype(np.int32)), max_iters)
    return labels[0].numpy().astype(np.int64), int(iters[0])


def _model_image(kind, H=16, W=128):
    if kind == "random":
        return (np.random.default_rng(11).random((H, W)) < 0.5).astype(np.int32)
    if kind == "checkerboard":
        yy, xx = np.mgrid[:H, :W]
        return ((yy + xx) % 2).astype(np.int32)
    return _spiral(H, W)


@pytest.mark.parametrize("rule", ["phase", "fg"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("band", [1, 3, 7, 32])
def test_banded_column_scan_equals_seg_min_scan(rule, reverse, band):
    """local band scan -> summaries -> fold -> apply == one segmented scan."""
    rng = np.random.default_rng(band + 10 * reverse)
    H, W = 32, 128
    # long vertical runs, so that carries cross several whole bands
    ph = (rng.random((H, W)) < 0.85).astype(np.int32)
    ph[:, ::5] = 1
    v = rng.integers(0, H * W, (H, W)).astype(np.int64)
    if rule == "fg":
        v[ph == 0] = tlab.BIG
        reset = 1 - ph
    else:
        prev = np.roll(ph, -1 if reverse else 1, axis=0)
        reset = (ph != prev).astype(np.int32)
        reset[-1 if reverse else 0] = 1
    want = tlab._seg_min_scan(torch.from_numpy(v.astype(np.int32))[None],
                              torch.from_numpy(reset.astype(np.int32))[None],
                              1, reverse)[0].numpy()
    got = _model_col_scan_banded(v, ph, rule, band, reverse)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", ["phase", "fg"])
@pytest.mark.parametrize("kind", ["random", "checkerboard", "spiral"])
@pytest.mark.parametrize("band", [1, 3, 7, 16])
def test_banded_iteration_equals_plain(rule, kind, band):
    """Each of the first iterations of the banded one-buffer scheme equals
    the plain version's (labels after k iterations, k = 1..3)."""
    ph = _model_image(kind)
    group = 160  # >= W + 1, a multiple of 32: a 3-row band takes 3 groups
    labels = _model_init(ph, rule)
    for k in (1, 2, 3):
        labels, _ = _model_iteration(labels, ph, rule, band, group)
        want, _ = _plain(ph, rule, k)
        np.testing.assert_array_equal(labels, want)


@pytest.mark.parametrize("rule", ["phase", "fg"])
@pytest.mark.parametrize("cap", [3, 9, 64])
def test_lowered_flag_gives_the_plain_iteration_count(rule, cap):
    """OR of "a pass lowered a value" == ``l2 != labels``: the same
    iteration count and labels at the cap (3, 9: cut short) and below it."""
    for kind in ("random", "spiral"):
        ph = _model_image(kind, H=8)
        got, it = _model_label(ph, rule, band=3, group=160, max_iters=cap)
        want, it_want = _plain(ph, rule, cap)
        assert it == it_want
        np.testing.assert_array_equal(got, want)
    full, it_full = _plain(_model_image("spiral", H=8), rule, 64)
    assert 3 < it_full < 64  # so caps 3 (and 9 or not) cut the spiral short


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32,
                                   torch.float32])
def test_label_wrappers_take_any_zero_one_type(dtype):
    """The kernels read one byte per pixel and the wrappers hand a bool
    over as it is; on the CPU every 0/1 type gives the same labels."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.random((2, 16, 128)) < 0.4)
    want2, it2 = tlab.label_components_combined(img.to(torch.int32))
    want5, it5 = tlab.label_components_batched(img.to(torch.int32))
    got2, git2 = tlab.label_components_combined(img.to(dtype))
    got5, git5 = tlab.label_components_batched(img.to(dtype))
    assert got2.dtype == got5.dtype == torch.int32
    assert torch.equal(got2, want2) and torch.equal(git2, it2)
    assert torch.equal(got5, want5) and torch.equal(git5, it5)
