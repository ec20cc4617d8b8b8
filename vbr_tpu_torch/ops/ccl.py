"""Contour-hierarchy mask cleanup via connected components.

Counterpart of ``vbr_tpu/ops/ccl.py``:

  * ``clean_masks_batched`` — the all-camera device cleanup: labels from
    kernel K2 (``ops.ccl_label``), then the component statistics from
    per-row run tables, with the same table caps (``kf``, ``kb``,
    ``k_runs``, ``k_keep``, ``k_hole``, ``k_touch``) and the same overflow
    bit per camera.  Where the JAX version reduces with one-hot compares
    (a TPU has no fast scatter), this one uses ``scatter_add_`` /
    ``gather`` over label space where that is the same integer sum, and
    the compares where the tables are small.  On a card the whole body is
    one CUDA graph per input shape (``graph_key``), captured once and
    replayed: its ~270 small launches cost the host one.
  * ``clean_mask_host`` — the exact host cleanup on ``scipy.ndimage``
    (8-connectivity labels, 3×3 maximum filter) in place of OpenCV; the
    fallback for a camera whose overflow bit is set.
  * ``label_components``, ``component_areas`` and ``clean_mask`` — the JAX
    package's one-image cleanup in plain torch ops, on the tensor's device
    (the ``"device-xla"`` route of the mask stage).  Its labels are those
    of the unpadded image, so they are not kernel K5's: K5 labels images
    padded to (8, 128) multiples, whose background padding joins
    components, with padded linear indices.

Semantics (the reference's hierarchy walk): foreground components with
area ≥ figure_threshold are kept and drawn solid; their holes (background
components not touching the image border) are re-carved when their
``cv2.contourArea`` (pixel count + 2×2 corner correction) is ≥
inner_threshold, and filled otherwise.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from vbr_tpu_torch.ops.ccl_label import (BIG, K2,
                                         label_components_batched_plain,
                                         label_components_combined)
from vbr_tpu_torch.utils import profiling


def _pad_to_tiles(H, W):
    return -(-H // 8) * 8, -(-W // 128) * 128


def _corner_contrib4(bg: torch.Tensor):
    """Per 2×2 block of a (B, H, W) bool hole-phase image: 4× its
    contribution to cv2.contourArea (c1 + 2·c2 + c3 + 2·cdiag)."""
    ha, hb = bg[:, :-1, :-1], bg[:, :-1, 1:]
    hc, hd = bg[:, 1:, :-1], bg[:, 1:, 1:]
    s = (ha.int() + hb.int() + hc.int() + hd.int())
    diag = (ha & hd & ~hb & ~hc) | (hb & hc & ~ha & ~hd)
    return ((s == 1).int() + 2 * ((s == 2) & ~diag).int()
            + 2 * diag.int() + (s == 3).int())


def _row_run_tables(fg, lab, k_runs, extra=None, counts_only=False):
    """Per-row run tables of both phases (see the JAX docstring): every
    maximal horizontal same-phase run carries one component label, and a
    component's root pixel (its min linear index) always starts a run.

    ``fg`` (B, Hp, Wp) bool, ``lab`` (B, Hp, Wp) i32 own-phase labels.
    Returns (length, label, isroot, isfg, extra_cnt, overflow), the tables
    flattened to (B, Hp·k_runs) in (row, slot) order, ``overflow`` (B,)
    where some row has more than ``k_runs`` runs (its extra runs are
    dropped, as the JAX one-hot reduction drops them)."""
    B, Hp, Wp = fg.shape
    ph = fg.to(torch.int32)
    left = F.pad(ph, (1, 0), value=-1)[..., :-1]
    is_start = ph != left
    rank = torch.cumsum(is_start.to(torch.int64), dim=2)
    slot = torch.clamp(rank - 1, max=k_runs)  # k_runs = dump slot
    overflow = (rank[..., -1] > k_runs).any(dim=1)

    def per_slot(values):
        out = torch.zeros((B, Hp, k_runs + 1), dtype=torch.int64,
                          device=fg.device)
        return out.scatter_add_(2, slot, values.to(torch.int64))[..., :k_runs]

    length = per_slot(torch.ones_like(ph)).reshape(B, -1)
    extra_cnt = (per_slot(extra) if extra is not None
                 else torch.zeros_like(length.reshape(B, Hp, k_runs))
                 ).reshape(B, -1)
    if counts_only:
        return length, None, None, None, extra_cnt, overflow

    lin = torch.arange(Hp * Wp, dtype=torch.int32,
                       device=fg.device).reshape(Hp, Wp)
    root_px = is_start & (lab == lin)
    # one start pixel per run: sum over the run of (value at its start)
    start_val = torch.where(is_start, lab.to(torch.int64) * 4
                            + root_px.to(torch.int64) * 2 + ph, 0)
    pack = per_slot(start_val).reshape(B, -1)
    valid = length > 0
    label = torch.where(valid, pack >> 2, -1)
    isroot = valid & ((pack & 2) > 0)
    isfg = valid & ((pack & 1) > 0)
    return length, label, isroot, isfg, extra_cnt, overflow


def _onehot_compact(values, flags, k):
    """First ``k`` ``values`` (B, n) where ``flags``, -1 padded, + count."""
    cs = torch.cumsum(flags.to(torch.int64), dim=1)
    count = cs[:, -1]
    idx = torch.where(flags & (cs - 1 < k), cs - 1, k)
    out = torch.zeros(values.shape[0], k + 1, dtype=values.dtype,
                      device=values.device)
    out = out.scatter_(1, idx, values)[:, :k]
    iot = torch.arange(k, device=values.device)
    return torch.where(iot[None, :] < count[:, None], out, -1), count


def _by_label(n_labels, labels, values):
    """(B, n_labels + 1) per-label sums of ``values`` at ``labels``; labels
    outside [0, n_labels) land in the last (discarded) slot."""
    idx = torch.where((labels >= 0) & (labels < n_labels), labels, n_labels)
    out = torch.zeros(labels.shape[0], n_labels + 1, dtype=torch.int64,
                      device=labels.device)
    return out.scatter_add_(1, idx.to(torch.int64), values.to(torch.int64))


def _lookup(table, keys):
    """table[b, key] for key ≥ 0 (0 elsewhere); keys (B, k)."""
    got = torch.gather(table, 1, torch.clamp(keys, min=0).to(torch.int64))
    return torch.where(keys >= 0, got, 0)


def _members(n_labels, roots, labels):
    """(B, n) bool: ``labels`` is one of ``roots`` (-1 entries match none)."""
    flag = _by_label(n_labels, roots, torch.ones_like(roots))
    flag[:, n_labels] = 0
    idx = torch.where((labels >= 0) & (labels < n_labels), labels, n_labels)
    return torch.gather(flag, 1, idx.to(torch.int64)) > 0


def _clean_stats(Lf, Lb, fgc, bgc, fig_thr, inner_thr, *, bidx, kf, kb,
                 k_runs, k_keep, k_hole, k_touch):
    """Statistics tail of :func:`clean_masks_batched` for B images.
    Returns ((B, Hp, Wp) bool cleaned, (B,) bool overflow)."""
    B, Hp, Wp = fgc.shape
    n = Hp * Wp
    lab2d = torch.where(fgc.reshape(B, -1), Lf, Lb).reshape(B, Hp, Wp)
    lent, labt, roott, isfgt, _, ovf_r = _row_run_tables(fgc, lab2d, k_runs)

    roots_f, nf = _onehot_compact(labt, roott & isfgt, kf)
    areas_f = _lookup(_by_label(n, labt, lent), roots_f)
    keep_f = (areas_f.float() >= fig_thr[:, None]) & (roots_f >= 0)
    kroots, nkeep = _onehot_compact(roots_f, keep_f, k_keep)
    kept_px = _members(n, kroots, Lf)

    kept_adj = F.max_pool2d(kept_px.reshape(B, 1, Hp, Wp).float(), 3,
                            stride=1, padding=1).reshape(B, Hp, Wp) > 0
    kadjt = _row_run_tables(fgc, lab2d, k_runs, extra=kept_adj,
                            counts_only=True)[4]

    roots_b, nb = _onehot_compact(labt, roott & ~isfgt, kb)
    border_labels = Lb[:, bidx]  # fg border pixels are BIG
    outside_b = (border_labels[:, :, None] == roots_b[:, None, :]).any(dim=1)
    hole_flags = (roots_b >= 0) & ~outside_b
    hroots, nhole = _onehot_compact(roots_b, hole_flags, k_hole)
    eq_hr = labt[:, :, None] == hroots[:, None, :]
    touch_b = (eq_hr & (kadjt > 0)[:, :, None]).any(dim=1)
    troots, ntouch = _onehot_compact(hroots, (hroots >= 0) & touch_b, k_touch)
    areas_b = torch.where(labt[:, :, None] == troots[:, None, :],
                          lent[:, :, None], 0).sum(dim=1)

    # hole polygon area: 2×2 corner contributions, attributed to the min
    # background label of each block
    labc = torch.where(bgc.reshape(B, -1), Lb, BIG).reshape(B, Hp, Wp)
    blmin = torch.minimum(
        torch.minimum(labc[:, :-1, :-1], labc[:, :-1, 1:]),
        torch.minimum(labc[:, 1:, :-1], labc[:, 1:, 1:]),
    ).reshape(B, -1)
    corner4 = _lookup(
        _by_label(n, blmin, _corner_contrib4(bgc).reshape(B, -1)), troots)
    poly_area = areas_b.float() + corner4.float() * 0.25
    fill_b = (troots >= 0) & (poly_area < inner_thr[:, None])
    fill_roots = torch.where(fill_b, troots, -1)
    hole_white_px = _members(n, fill_roots, Lb)

    out = (kept_px | hole_white_px).reshape(B, Hp, Wp)
    overflow = (ovf_r | (nf > kf) | (nb > kb) | (nkeep > k_keep)
                | (nhole > k_hole) | (ntouch > k_touch))
    return out, overflow


def _border_indices(H, W, Hp, Wp) -> np.ndarray:
    """Padded linear indices of the true border plus one padding pixel
    (the padding is one connected background region)."""
    bidx = [np.arange(Wp), (H - 1) * Wp + np.arange(Wp),
            np.arange(Hp) * Wp, np.arange(Hp) * Wp + (W - 1)]
    if Hp > H:
        bidx.append(np.array([H * Wp]))
    elif Wp > W:
        bidx.append(np.array([W]))
    return np.unique(np.concatenate(bidx)).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _device_constants(H, W, Hp, Wp, fig_thresholds, inner_thresholds, dev):
    """The border pixels' indices and the per-image thresholds of
    :func:`clean_masks_batched` on ``dev``, made once per shape and
    thresholds: a copy from the host in every call would make the host wait
    for the card."""
    return (torch.from_numpy(_border_indices(H, W, Hp, Wp)).to(dev),
            torch.tensor(fig_thresholds, dtype=torch.float32, device=dev),
            torch.tensor(inner_thresholds, dtype=torch.float32, device=dev))


def graph_key(raw: torch.Tensor, fig_thresholds, inner_thresholds, *,
              kf: int, kb: int, k_runs: int, max_iters: int) -> tuple:
    """What every launch of :func:`clean_masks_batched`'s body depends on,
    and so the key of its captured graph: the input's device, dtype and
    shape, the threshold tuples and the table caps."""
    return (raw.device, raw.dtype, tuple(raw.shape),
            tuple(map(float, fig_thresholds)),
            tuple(map(float, inner_thresholds)), kf, kb, k_runs, max_iters)


class _Graph:
    """One captured body: its static input, its static outputs and the
    stream of its latest replay."""

    def __init__(self, graph, static_in, out, overflow, keep):
        self.graph = graph
        self.static_in = static_in
        self.out = out
        self.overflow = overflow
        self.keep = keep  # device constants the graph reads
        self.stream = torch.cuda.current_stream(static_in.device)

    def replay(self, raw):
        """Copy ``raw`` in, replay on the current stream, return clones of
        the outputs (the next replay overwrites the static ones).  A replay
        on another stream than the last first waits for that stream, so two
        replays never share the buffers on the device."""
        stream = torch.cuda.current_stream(raw.device)
        if stream != self.stream:
            stream.wait_stream(self.stream)
            self.stream = stream
        self.static_in.copy_(raw)
        self.graph.replay()
        K2.launches += 1  # the graph holds one K2 launch
        profiling.count("cleanup_graph_replays")
        return self.out.clone(), self.overflow.clone()


def _capture(raw, body, fig, inner):
    """``body`` captured in a CUDA graph on a static copy of ``raw``: one
    warm-up run on a side stream first, which fills the caches its launches
    read (``_device_constants``, ``kernel_route``), so that no copy from the
    host falls inside the capture.  Neither run counts as a K2 launch."""
    launches = K2.launches
    static_in = torch.empty_like(raw, memory_format=torch.contiguous_format)
    static_in.copy_(raw)
    side = torch.cuda.Stream(raw.device)
    side.wait_stream(torch.cuda.current_stream(raw.device))
    with torch.cuda.stream(side):
        body(static_in)
    torch.cuda.current_stream(raw.device).wait_stream(side)
    H, W = raw.shape[1:]
    keep = _device_constants(H, W, *_pad_to_tiles(H, W), fig, inner,
                             raw.device)
    graph = torch.cuda.CUDAGraph()
    # other threads may go on with their own CUDA calls meanwhile
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out, overflow = body(static_in)
    K2.launches = launches
    profiling.count("cleanup_graph_captures")
    return _Graph(graph, static_in, out, overflow, keep)


class _GraphCache:
    """The captured graphs of :func:`clean_masks_batched`, least recently
    used first, at most ``size`` (each keeps a private memory pool).  One
    lock covers the capture and the copy-in, replay and clones of a call,
    so threads that share a key take turns."""

    def __init__(self, size: int):
        self.size = size
        self._graphs = collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, key, raw, body, fig, inner):
        with self._lock, torch.cuda.device(raw.device):
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = _capture(raw, body, fig, inner)
                if len(self._graphs) > self.size:
                    # its buffers go back to the allocator: let its last
                    # replay finish first
                    self._graphs.popitem(last=False)[1].stream.synchronize()
            else:
                self._graphs.move_to_end(key)
            return entry.replay(raw)


_graphs = _GraphCache(8)


def clean_masks_batched(
    raw: torch.Tensor,  # (C, H, W) u8 {0, 255}
    fig_thresholds,
    inner_thresholds,
    *,
    kf: int = 512,
    kb: int = 128,
    k_runs: int = 64,
    max_iters: int = 64,
):
    """All-camera contour-hierarchy cleanup on the device.

    Returns (cleaned (C, H, W) u8, overflow (C,) bool).  ``overflow[c]`` is
    set when camera c exceeded any table (more than ``k_runs`` runs in a
    row, ``kf`` fg or ``kb`` bg components, ``k_keep`` = min(16, kf) kept
    figures, ``k_hole`` = min(64, kb) holes, ``k_touch`` = min(32, k_hole)
    touched holes); its result is then truncated and the caller must redo
    it with :func:`clean_mask_host`.

    On a CUDA tensor the body (padding, K2, the run-table statistics) runs
    as one CUDA graph, captured at the first call of each :func:`graph_key`
    and replayed after: some 270 launches become one copy in, one replay
    and two clones out, bit-equal to the body run eagerly.  Calls share a
    graph under a lock, and a replay waits for the stream of the one before
    it.  A CPU tensor, or a call made while the current stream is itself
    being captured, runs the body eagerly.  The recorder counts
    ``cleanup_graph_captures`` and ``cleanup_graph_replays``."""
    fig = tuple(map(float, fig_thresholds))
    inner = tuple(map(float, inner_thresholds))

    def body(x):
        return _clean_masks_eager(x, fig, inner, kf, kb, k_runs, max_iters)

    if raw.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return body(raw)
    key = graph_key(raw, fig, inner, kf=kf, kb=kb, k_runs=k_runs,
                    max_iters=max_iters)
    return _graphs(key, raw, body, fig, inner)


def _clean_masks_eager(raw, fig, inner, kf, kb, k_runs, max_iters):
    """The body of :func:`clean_masks_batched`, launch by launch: pad to
    tiles, K2, the statistics, unpad to u8."""
    C, H, W = raw.shape
    dev = raw.device
    Hp, Wp = _pad_to_tiles(H, W)
    fg_p = torch.zeros((C, Hp, Wp), dtype=torch.bool, device=dev)
    fg_p[:, :H, :W] = raw > 0
    bg_p = ~fg_p
    comb, _ = label_components_combined(fg_p, max_iters=max_iters)
    labs_f = torch.where(fg_p, comb, BIG).reshape(C, -1)
    labs_b = torch.where(bg_p, comb, BIG).reshape(C, -1)
    bidx, fig_t, inner_t = _device_constants(H, W, Hp, Wp, fig, inner, dev)
    k_keep = min(16, kf)
    k_hole = min(64, kb)
    k_touch = min(32, k_hole)
    out_p, overflow = _clean_stats(
        labs_f, labs_b, fg_p, bg_p, fig_t, inner_t, bidx=bidx, kf=kf, kb=kb,
        k_runs=k_runs, k_keep=k_keep, k_hole=k_hole, k_touch=k_touch,
    )
    out = torch.where(out_p[:, :H, :W], 255, 0).to(torch.uint8)
    return out, overflow


def clean_mask_host(raw_mask, figure_threshold: float,
                    inner_threshold: float) -> np.ndarray:
    """Exact host cleanup of one (H, W) mask on scipy; (H, W) u8 {0, 255}.

    Both phases are labelled 8-connected.  Within a 2×2 block all
    background pixels are 8-adjacent, so each block holds at most one
    background label and the corner attribution needs no label order.
    """
    mask = np.asarray(raw_mask) > 0
    eight = np.ones((3, 3), dtype=bool)
    labels_f, n_f = ndimage.label(mask, structure=eight)
    areas_f = np.bincount(labels_f.ravel(), minlength=n_f + 1)
    keep = areas_f >= figure_threshold
    keep[0] = False
    kept_img = keep[labels_f]

    bg = ~mask
    labels_b, n_b = ndimage.label(bg, structure=eight)
    border = np.zeros(n_b + 1, dtype=bool)
    for edge in (labels_b[0, :], labels_b[-1, :],
                 labels_b[:, 0], labels_b[:, -1]):
        border[edge] = True
    areas_b = np.bincount(labels_b.ravel(), minlength=n_b + 1)

    lab_pad = np.pad(labels_b, 1)
    blocks = (lab_pad[:-1, :-1], lab_pad[:-1, 1:],
              lab_pad[1:, :-1], lab_pad[1:, 1:])
    contrib4 = _corner_contrib4(
        torch.from_numpy(np.pad(bg, 1)[None])).numpy()[0]
    blabel = np.max(np.stack(blocks), axis=0)  # the one bg label, or 0
    corner = np.bincount(blabel.ravel(), weights=contrib4.ravel() / 4.0,
                         minlength=n_b + 1)

    kept_dil = ndimage.maximum_filter(kept_img, size=3, mode="constant",
                                      cval=False)
    touch = np.bincount(labels_b.ravel(), weights=kept_dil.ravel(),
                        minlength=n_b + 1) > 0
    hole = ~border & touch
    hole[0] = False
    poly_area = areas_b + corner
    fill = hole & (poly_area < inner_threshold)
    out = kept_img | fill[labels_b]
    return np.where(out, np.uint8(255), np.uint8(0))


def label_components(fg: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """8-connected component labels of a (H, W) boolean mask: for a
    foreground pixel the minimum linear index of its component, 2³⁰ on the
    background.  The JAX package's iteration (3×3 neighbour min, then row
    and column segmented min-scans, until nothing changes or ``max_iters``
    iterations) in plain torch ops on ``fg``'s device."""
    labels, _ = label_components_batched_plain(fg[None], max_iters)
    return labels[0]


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count per label root, indexed by linear pixel index (HW,) i32."""
    flat = labels.reshape(-1)
    valid = flat < BIG
    idx = torch.where(valid, flat, 0).long()
    return torch.zeros(flat.numel(), dtype=torch.int32,
                       device=labels.device).index_add_(0, idx, valid.int())


def clean_mask(raw_mask: torch.Tensor, figure_threshold: float,
               inner_threshold: float, max_iters: int = 64) -> torch.Tensor:
    """The contour-hierarchy cleanup of one (H, W) u8 {0, 255} mask through
    :func:`label_components` (see the module docstring); (H, W) u8
    {0, 255} on the mask's device."""
    H, W = raw_mask.shape
    dev = raw_mask.device
    fg = raw_mask > 0

    # 1. foreground components kept by pixel area
    labels_f = label_components(fg, max_iters)
    areas_f = component_areas(labels_f)
    flat_f = labels_f.reshape(-1)
    valid_f = flat_f < BIG
    pix_area_f = torch.where(valid_f,
                             areas_f[torch.where(valid_f, flat_f, 0).long()], 0)
    kept = valid_f & (pix_area_f >= figure_threshold)

    # 2. background components; those touching the border are "outside"
    bg = ~fg
    labels_b = label_components(bg, max_iters)
    flat_b = labels_b.reshape(-1)
    valid_b = flat_b < BIG
    border = torch.zeros((H, W), dtype=torch.bool, device=dev)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    outside_root = torch.zeros(H * W, dtype=torch.bool, device=dev)
    outside_root[flat_b[(border & bg).reshape(-1)].long()] = True
    b_idx = torch.where(valid_b, flat_b, 0).long()
    hole = valid_b & ~outside_root[b_idx]  # enclosed background

    # 3. a hole belongs to a kept component when a kept pixel touches it
    kept_adjacent = F.max_pool2d(kept.reshape(1, 1, H, W).float(), 3,
                                 stride=1, padding=1).reshape(-1) > 0
    hole_idx = torch.where(hole, flat_b, 0).long()
    touch_kept = torch.zeros(H * W, dtype=torch.bool, device=dev)
    touch_kept[hole_idx[hole & kept_adjacent]] = True
    in_kept_hole = hole & touch_kept[hole_idx]

    # 4. hole area in cv2.contourArea terms: pixels + 2×2 corner counts
    hole_area_pix = component_areas(labels_b)[hole_idx]
    lab_img = torch.where(bg.reshape(-1), flat_b, BIG).reshape(H, W)
    lp = F.pad(lab_img, (1, 1, 1, 1), value=BIG)
    blabel = torch.minimum(torch.minimum(lp[:-1, :-1], lp[:-1, 1:]),
                           torch.minimum(lp[1:, :-1], lp[1:, 1:])).reshape(-1)
    contrib = _corner_contrib4(F.pad(bg, (1, 1, 1, 1))[None])[0].reshape(-1)
    bvalid = blabel < BIG
    corner_area = torch.zeros(H * W, dtype=torch.float32, device=dev)
    corner_area.index_add_(0, torch.where(bvalid, blabel, 0).long(),
                           torch.where(bvalid, contrib * 0.25, 0.0))
    hole_poly_area = hole_area_pix.float() + corner_area[hole_idx]
    carve = in_kept_hole & (hole_poly_area >= inner_threshold)

    # 5. kept foreground and the small holes of kept components
    out = kept | (in_kept_hole & ~carve)
    return torch.where(out.reshape(H, W), 255, 0).to(torch.uint8)
