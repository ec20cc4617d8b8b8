"""Report figures (plots/ artifacts), drawn without matplotlib.

The port's counterpart of ``vbr_tpu/pipelines/reports.py``, with its three
figures, arguments, defaults and output paths:
  * background-model mask comparison grid
    (background_subtraction.py:296-340 → background_models_mask_comparisons.png)
  * intrinsic-calibration parameter/error comparison across runs
    (camera_calibration.py:612-705 → intrinsic_params_*.png)
  * marching-cubes surface snapshot (voxel_reconstruction.py:127-163)

Each function first builds a figure description (``Figure``: panels with
their boxes in pixels, data limits, ticks and tick labels, titles, bars,
error bars, lines, legend entries, images), then ``_rasterise`` writes it
as an RGB PNG.  The description follows matplotlib's rules for what it
holds: ``figsize`` × 100 dpi, the axes limits of its autoscale (data
limits, 5 % margins, bars sticky at 0), the ticks of its ``AutoLocator``
and the labels of its ``ScalarFormatter``, the colour cycle, and for the
mask grid the panel boxes of ``tight_layout`` around aspect-locked images.
Text goes through PIL's ``ImageDraw`` and its default font, and the layout
of the two plot figures is drawn in a fixed frame, so glyphs and
decorations are not matplotlib's while the figure carries the same data
and labels.  PIL is imported at the first draw (a missing PIL raises
``ImportError`` naming Pillow); the PNG goes through
``viewer/headless.save_png``.

The mesh snapshot is the one figure with work for a device: the (T, 3, 3)
triangles are projected with matplotlib's 3D view (``Axes3D.get_proj`` of
matplotlib 3.10 for ``view_init(elev, azim)``: the bounding box as the
limits, box aspect (4, 4, 3), perspective with focal length 1), ordered as
``Poly3DCollection`` orders them (descending mean projected depth, stable)
and rasterised in torch on ``device``: ``tab:blue`` at alpha 0.9 over the
axes' background, a black edge of 0.1 pt at alpha 0.9 on the front face.
The projection is f64 multiplies and adds in a fixed order, divisions are
by tensors and the sort is stable (as in ``viewer/headless.py``), so the
card's image is bit-equal to the CPU's.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

DPI = 100  # matplotlib's figure.dpi: a figsize inch is 100 pixels
PT = DPI / 72.0  # pixels per point
# matplotlib's default colour cycle ("tab10")
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
MARGIN = 0.05  # axes.xmargin / axes.ymargin
TICK_FONT_PT = 10.0  # xtick.labelsize / ytick.labelsize ("medium")
MAX_BINS = 9  # MaxNLocator's ceiling for nbins="auto"
STEPS = (1.0, 2.0, 2.5, 5.0, 10.0)  # AutoLocator's steps
# tight_layout of the mask grid: its pad (1.08 of the 10 pt font) and
# matplotlib's title box at 12 pt in DejaVu Sans: it starts 6 pt (titlepad)
# less its 4 px descent above the axes and is 18 px tall
LAYOUT_PAD_PX = 1.08 * TICK_FONT_PT * PT
TITLE_GAP_PX = 6.0 * PT - 4.0
TITLE_H_PX = 18.0
SUBPLOT_PARS = (0.125, 0.9, 0.11, 0.88, 0.2, 0.2)  # left right bottom top ws hs
# the mesh: the 3D axes fill tight_layout's box of one 3D subplot
MESH_FIG_PX = 1000
MESH_AXES_FRAC = (0.015, 0.985)  # its box, in figure fractions, both axes
MESH_VIEW = (-0.95 / 10, 0.9 / 10)  # Axes3D.set_top_view's 2-D limits
MESH_DIST = 10.0  # Axes3D._dist
MESH_BOX_ASPECT = (4.0, 4.0, 3.0)
MESH_ALPHA = 0.9
MESH_EDGE_PX = 0.1 * PT  # the edges' 0.1 pt
MESH_MAX_LAYERS = 16  # 0.1 ** 16: deeper layers change no 8-bit level
PANE_RGB = (249, 249, 249)  # (0.95, 0.95, 0.95) at alpha 0.5 over white


def _rgb(hex_colour: str) -> Tuple[int, int, int]:
    h = hex_colour.lstrip("#")
    return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))


# ---------------------------------------------------------------------------
# the figure description
# ---------------------------------------------------------------------------


@dataclass
class Bar:
    left: float  # x − width / 2, as ``Axes.bar`` stores it
    width: float
    height: float
    color: str
    yerr: Optional[float] = None
    label: Optional[str] = None

    @property
    def centre(self) -> float:
        """Where ``Axes.bar`` puts the error bar: left + ½·width."""
        return self.left + 0.5 * self.width

    @property
    def right(self) -> float:
        return self.left + self.width


@dataclass
class Line:
    x: np.ndarray
    y: np.ndarray
    color: str
    marker: str = "o"
    label: Optional[str] = None


@dataclass
class Panel:
    box: Tuple[float, float, float, float]  # x0, y0, x1, y1 px, y down
    title: str = ""
    xlabel: str = ""
    axis_on: bool = True
    xlim: Tuple[float, float] = (0.0, 1.0)
    ylim: Tuple[float, float] = (0.0, 1.0)
    xticks: List[Tuple[float, str]] = field(default_factory=list)
    yticks: List[Tuple[float, str]] = field(default_factory=list)
    yoffset: str = ""  # the ScalarFormatter's offset text, if any
    bars: List[Bar] = field(default_factory=list)
    lines: List[Line] = field(default_factory=list)
    legend: List[Tuple[str, str]] = field(default_factory=list)  # label, colour
    image: Optional[np.ndarray] = None  # (h, w) u8 grey, drawn over the box


@dataclass
class Figure:
    size: Tuple[int, int]  # width, height px
    panels: List[Panel] = field(default_factory=list)


# ---------------------------------------------------------------------------
# matplotlib's axis rules (linear scale, autolimit_mode "data")
# ---------------------------------------------------------------------------


def _nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    """``matplotlib.transforms.nonsingular`` (increasing)."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        vmin -= expander * abs(vmin)
        vmax += expander * abs(vmax)
    return vmin, vmax


def _autoscale(lo, hi, stickies=()):
    """An axis' view limits from its data limits: the locator's
    ``nonsingular`` (expander 0.05), margins of 5 % that do not cross a
    sticky value, then ``nonsingular`` again (``autoscale_view``)."""
    x0, x1 = _nonsingular(lo, hi, expander=0.05)
    st = np.sort(np.asarray(stickies, np.float64))
    tol = 1e-5 * abs(x1 - x0)
    i0 = np.searchsorted(st, x0 + tol) - 1
    i1 = np.searchsorted(st, x1 - tol)
    delta = (x1 - x0) * MARGIN
    x0, x1 = x0 - delta, x1 + delta
    if i0 != -1:
        x0 = max(x0, float(st[i0]))
    if i1 != len(st):
        x1 = min(x1, float(st[i1]))
    return _nonsingular(x0, x1)


def _tick_bins(length_px, per_label_pt):
    """MaxNLocator's ``nbins="auto"``: the axis length in points over the
    room one label takes (3 × the tick font for x, 2 × for y), in [1, 9]."""
    space = int(np.floor(length_px / PT / per_label_pt))
    return int(np.clip(space, 1, MAX_BINS))


def _edge_floor(x, step, offset):
    """``_Edge_integer.le``: the largest n with n·step <= x."""
    d, m = divmod(x, step)
    return d + 1 if _close(m / step, 1, step, offset) else d


def _edge_ceil(x, step, offset):
    """``_Edge_integer.ge``: the smallest n with n·step >= x."""
    d, m = divmod(x, step)
    return d if _close(m / step, 0, step, offset) else d + 1


def _close(ms, edge, step, offset):
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(offset / step) - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def _max_n_locs(vmin, vmax, nbins):
    """``MaxNLocator(nbins, steps=[1, 2, 2.5, 5, 10]).tick_values``."""
    vmin, vmax = _nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < 100:
        offset = 0.0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = np.concatenate([0.1 * np.asarray(STEPS[:-1]), STEPS,
                            [10 * STEPS[1]]]) * scale
    raw_step = (_vmax - _vmin) / nbins
    large = np.nonzero(steps >= raw_step)[0]
    istep = large[0] if len(large) else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        low = _edge_floor(_vmin - best_vmin, step, abs(offset))
        high = _edge_ceil(_vmax - best_vmin, step, abs(offset))
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def _scalar_labels(locs, view):
    """``ScalarFormatter.format_ticks`` (offset threshold 4, power limits
    (-5, 6), Unicode minus) → (labels, offset text)."""
    locs = np.asarray(locs, np.float64)
    vmin, vmax = sorted(view)
    vis = locs[(vmin <= locs) & (locs <= vmax)]
    offset = 0.0
    if len(vis):
        lmin, lmax = vis.min(), vis.max()
        if not (lmin == lmax or lmin <= 0 <= lmax):
            abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
            sign = math.copysign(1, lmin)
            oom_max = np.ceil(math.log10(abs_max))
            oom = 1 + next(o for o in itertools.count(oom_max, -1)
                           if abs_min // 10 ** o != abs_max // 10 ** o)
            if (abs_max - abs_min) / 10 ** oom <= 1e-2:
                oom = 1 + next(o for o in itertools.count(oom_max, -1)
                               if abs_max // 10 ** o - abs_min // 10 ** o > 1)
            if abs_max // 10 ** oom >= 10 ** 3:
                offset = sign * (abs_max // 10 ** oom) * 10 ** oom
    order = 0
    if len(vis):
        if offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            val = np.abs(vis).max()
            oom = 0 if val == 0 else math.floor(math.log10(val))
        if oom <= -5 or oom >= 6:
            order = oom
    _locs = list(locs) if len(locs) >= 2 else [*locs, vmin, vmax]
    scaled = (np.asarray(_locs) - offset) / 10.0 ** order
    rng = np.ptp(scaled)
    if rng == 0:
        rng = np.max(np.abs(scaled))
    if rng == 0:
        rng = 1
    if len(locs) < 2:
        scaled = scaled[:-2]
    rng_oom = int(math.floor(math.log10(rng)))
    sigfigs = max(0, 3 - rng_oom)
    thresh = 1e-3 * 10 ** rng_oom
    while sigfigs >= 0:
        if np.abs(scaled - np.round(scaled, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    fmt = f"%1.{sigfigs + 1}f"

    def fix_minus(s):
        return s.replace("-", "\N{MINUS SIGN}")

    labels = []
    for x in locs:
        xp = (x - offset) / 10.0 ** order
        labels.append(fix_minus(fmt % (0 if abs(xp) < 1e-8 else xp)))
    text = ""
    if order or offset:
        off = ""
        if offset:
            off = _format_data(offset)
            if offset > 0:
                off = "+" + off
        text = fix_minus(("1e%d" % order if order else "") + off)
    return labels, text


def _format_data(value):
    """``ScalarFormatter.format_data``: up to 10 significant digits of the
    significand, then ``e`` and the exponent (none for 10⁰)."""
    e = math.floor(math.log10(abs(value)))
    s = round(value / 10 ** e, 10)
    significand = ("%d" if s % 1 == 0 else "%1.10g") % s
    return significand if e == 0 else f"{significand}e{e:d}"


def _visible(locs, labels, view):
    """The ticks an axis draws: those within its view interval (with
    matplotlib's 1e-10 relative slack)."""
    a, b = sorted(view)
    slack = (b - a) * 1e-10
    return [(float(v), s) for v, s in zip(locs, labels)
            if a - slack <= v <= b + slack]


def _numeric_ticks(view, length_px, per_label_pt):
    """(visible (value, label) pairs, offset text) of an ``AutoLocator`` /
    ``ScalarFormatter`` axis with limits ``view``."""
    locs = _max_n_locs(*view, _tick_bins(length_px, per_label_pt))
    labels, offset = _scalar_labels(locs, view)
    return _visible(locs, labels, view), offset


# ---------------------------------------------------------------------------
# the three figures
# ---------------------------------------------------------------------------


def _grid_cells(rows, cols, pars):
    """GridSpec cell boxes (x0, y0, x1, y1) in figure fractions, y up, for
    subplot parameters ``pars`` (left, right, bottom, top, wspace,
    hspace)."""
    left, right, bottom, top, wspace, hspace = pars
    cell_h = (top - bottom) / (rows + hspace * (rows - 1))
    cell_w = (right - left) / (cols + wspace * (cols - 1))
    cells = {}
    for r in range(rows):
        y1 = top - r * cell_h * (1 + hspace)
        for c in range(cols):
            x0 = left + c * cell_w * (1 + wspace)
            cells[r, c] = (x0, y1 - cell_h, x0 + cell_w, y1)
    return cells


def _fit_aspect(cell, box_aspect, fig_aspect):
    """``Bbox.shrunk_to_aspect`` then ``anchored("C")``: the largest box
    of height/width ``box_aspect`` (display units) centred in ``cell``."""
    x0, y0, x1, y1 = cell
    w, h = x1 - x0, y1 - y0
    H = w * box_aspect / fig_aspect
    if H <= h:
        W = w
    else:
        W, H = h * fig_aspect / box_aspect, h
    cx, cy = x0 + (w - W) / 2, y0 + (h - H) / 2
    return (cx, cy, cx + W, cy + H)


def _mask_grid_boxes(rows, cols, img_hw, fig_w, fig_h):
    """The image boxes of ``tight_layout`` over a rows × cols grid of
    ``imshow`` panels with axes off and a title each, in figure fractions
    (y up): the pads and the spaces measured on the default layout, then
    the images fitted into the new cells."""
    aspect = img_hw[0] / img_hw[1]
    fig_aspect = fig_h / fig_w
    cells = _grid_cells(rows, cols, SUBPLOT_PARS)
    hsp = np.zeros((rows, cols + 1))
    vsp = np.zeros((rows + 1, cols))
    title_top = (TITLE_GAP_PX + TITLE_H_PX) / fig_h
    for (r, c), cell in cells.items():
        x0, y0, x1, y1 = _fit_aspect(cell, aspect, fig_aspect)
        hsp[r, c] += cell[0] - x0
        hsp[r, c + 1] += x1 - cell[2]
        vsp[r, c] += (y1 + title_top) - cell[3]
        vsp[r + 1, c] += cell[1] - y0
    pad_w, pad_h = LAYOUT_PAD_PX / fig_w, LAYOUT_PAD_PX / fig_h
    m_left = max(hsp[:, 0].max(), 0) + pad_w
    m_right = max(hsp[:, -1].max(), 0) + pad_w
    m_top = max(vsp[0].max(), 0) + pad_h
    m_bottom = max(vsp[-1].max(), 0) + pad_h
    wspace = hspace = 0.2
    if cols > 1:
        sp = hsp[:, 1:-1].max() + pad_w
        wspace = sp / ((1 - m_right - m_left - sp * (cols - 1)) / cols)
    if rows > 1:
        sp = vsp[1:-1].max() + pad_h
        hspace = sp / ((1 - m_top - m_bottom - sp * (rows - 1)) / rows)
    pars = (m_left, 1 - m_right, m_bottom, 1 - m_top, wspace, hspace)
    return {rc: _fit_aspect(cell, aspect, fig_aspect)
            for rc, cell in _grid_cells(rows, cols, pars).items()}


def _px_box(frac_box, fig_w, fig_h):
    """A figure-fraction box (y up) → pixels (x0, y0, x1, y1), y down."""
    x0, y0, x1, y1 = frac_box
    return (x0 * fig_w, (1 - y1) * fig_h, x1 * fig_w, (1 - y0) * fig_h)


def _grey_levels(mask) -> np.ndarray:
    """``imshow(cmap="gray")``'s levels: the mask normalised to its own
    min..max (a constant mask is black), then the 256-entry colormap."""
    m = np.asarray(mask, np.float64)
    lo, hi = float(m.min()), float(m.max())
    v = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
    return np.clip(np.floor(v * 256), 0, 255).astype(np.uint8)


def mask_comparison_figure(masks_by_model: dict) -> Figure:
    """The description of ``plot_mask_comparison``'s figure."""
    models = list(masks_by_model.keys())
    num_cams = len(next(iter(masks_by_model.values())))
    fig_w, fig_h = 600 * len(models), 500 * num_cams
    fig = Figure((fig_w, fig_h))
    img_hw = np.shape(masks_by_model[models[0]][0])[:2]
    boxes = _mask_grid_boxes(num_cams, len(models), img_hw, fig_w, fig_h)
    for c in range(num_cams):
        for m, name in enumerate(models):
            fig.panels.append(Panel(
                box=_px_box(boxes[c, m], fig_w, fig_h),
                title=f"Camera {c + 1} — {name}", axis_on=False,
                image=_grey_levels(masks_by_model[name][c])))
    return fig


# the intrinsics figure's frame: three columns of 600 px, each axes inset
# by room for its tick labels (left), title (top) and x label (bottom)
INTRINSICS_SIZE = (1800, 500)
INTRINSICS_INSET = (62, 34, 12, 52)  # left, top, right, bottom px


def intrinsic_results_figure(runs: Sequence[dict]) -> Figure:
    """The description of ``plot_intrinsic_results``' figure."""
    W, H = INTRINSICS_SIZE
    fig = Figure((W, H))
    boxes = []
    for i in range(3):
        l, t, r, b = INTRINSICS_INSET
        boxes.append((i * W / 3 + l, t, (i + 1) * W / 3 - r, H - b))
    labels = [r["label"] for r in runs]

    def finish(p, xdata, ydata, ystickies=(), xticks=None):
        p.xlim = _autoscale(min(xdata), max(xdata))
        p.ylim = _autoscale(min(ydata), max(ydata), ystickies)
        w, h = p.box[2] - p.box[0], p.box[3] - p.box[1]
        if xticks is None:
            p.xticks, _ = _numeric_ticks(p.xlim, w, 3 * TICK_FONT_PT)
        else:
            p.xticks = _visible([v for v, _ in xticks],
                                [s for _, s in xticks], p.xlim)
        p.yticks, p.yoffset = _numeric_ticks(p.ylim, h, 2 * TICK_FONT_PT)
        fig.panels.append(p)

    # the mean errors: categorical bars (one category per distinct label)
    cats = list(dict.fromkeys(labels))
    p = Panel(box=boxes[0], title="Mean reprojection error (px)")
    p.bars = [Bar(float(cats.index(r["label"])) - 0.4, 0.8, float(r["rms"]),
                  TAB10[0]) for r in runs]
    finish(p, [b.left for b in p.bars] + [b.right for b in p.bars],
           [0.0] + [b.height for b in p.bars], ystickies=[0.0] * len(runs),
           xticks=[(float(i), s) for i, s in enumerate(cats)])

    # the per-view errors: one line per run, markers, a legend
    p = Panel(box=boxes[1], title="Per-view reprojection error (px)",
              xlabel="view")
    for i, r in enumerate(runs):
        y = np.asarray(r["per_view_errors"], np.float64).reshape(-1)
        p.lines.append(Line(np.arange(len(y), dtype=np.float64), y,
                            TAB10[i % 10], "o", r["label"]))
    p.legend = [(ln.label, ln.color) for ln in p.lines]
    finish(p, np.concatenate([ln.x for ln in p.lines]),
           np.concatenate([ln.y for ln in p.lines]))

    # the intrinsics: grouped bars with the first four stds as error bars
    names = ["fx", "fy", "cx", "cy"]
    x = np.arange(len(names))
    width = 0.8 / max(len(runs), 1)
    p = Panel(box=boxes[2], title="Intrinsics ± std")
    for i, r in enumerate(runs):
        K = np.asarray(r["K"])
        vals = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
        errs = np.asarray(r.get("intrinsic_std", np.zeros(9)))[:4]
        for xi, v, e in zip(x + i * width, vals, errs):
            p.bars.append(Bar(float(xi) - width / 2, width, float(v),
                              TAB10[i % 10],
                              yerr=float(e), label=r["label"]))
        p.legend.append((r["label"], TAB10[i % 10]))
    tick_x = x + 0.4 - width / 2
    finish(p, [b.left for b in p.bars] + [b.right for b in p.bars],
           [0.0] + [b.height for b in p.bars]
           + [b.height + b.yerr for b in p.bars]
           + [b.height - b.yerr for b in p.bars],
           ystickies=[0.0] * len(p.bars),
           xticks=[(float(v), s) for v, s in zip(tick_x, names)])
    return fig


# ---------------------------------------------------------------------------
# the rasteriser (host, PIL)
# ---------------------------------------------------------------------------


def _pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("the report figures draw their text and shapes "
                          "with Pillow (the 'PIL' package), which is not "
                          f"installed: {e}") from e
    return Image, ImageDraw, ImageFont


def _font(ImageFont, size_pt):
    """PIL's default font at ``size_pt`` (a scalable font where the Pillow
    build has FreeType, else its fixed bitmap font)."""
    try:
        return ImageFont.load_default(size=size_pt * PT)
    except (TypeError, AttributeError, OSError):
        return ImageFont.load_default()


# stand-ins for the dashes of titles and tick labels where the font lacks them
_GLYPH_FALLBACK = {"\N{EM DASH}": "-", "\N{MINUS SIGN}": "-"}


def _drawable(text, font):
    """``text`` with each character the font has no glyph for (it draws
    the same box as a private-use character) replaced by its stand-in."""
    def missing(ch):
        try:
            return bytes(font.getmask(ch)) == bytes(font.getmask("\ue000"))
        except UnicodeEncodeError:  # a bitmap font: Latin-1 only
            return True
    return "".join(_GLYPH_FALLBACK.get(ch, ch)
                   if ch in _GLYPH_FALLBACK and missing(ch) else ch
                   for ch in text)


def _area_rows(a, n_out):
    """``a`` (f64, rows first) resampled to ``n_out`` rows by area (a box
    filter): differences of the piecewise-linear running integral."""
    n_in = a.shape[0]
    run = np.concatenate([np.zeros((1,) + a.shape[1:]), np.cumsum(a, 0)])
    edges = np.arange(n_out + 1) * (n_in / n_out)
    i = np.minimum(np.floor(edges).astype(np.int64), n_in - 1)
    integral = run[i] + (edges - i)[:, None] * a[i]
    return (integral[1:] - integral[:-1]) / (n_in / n_out)


def _resample(img, w, h):
    """An (H, W) u8 grey image resampled to (h, w) by area."""
    a = _area_rows(_area_rows(img.astype(np.float64), h).T, w).T
    return np.clip(np.floor(a + 0.5), 0, 255).astype(np.uint8)


def _rasterise(fig: Figure) -> np.ndarray:
    """Draw a description → (H, W, 3) u8 RGB."""
    Image, ImageDraw, ImageFont = _pil()
    W, H = fig.size
    canvas = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(canvas)
    title_font = _font(ImageFont, 12.0)
    tick_font = _font(ImageFont, TICK_FONT_PT)

    def text(xy, s, font, anchor):
        draw.text(xy, _drawable(s, font), fill="black", font=font,
                  anchor=anchor)

    for p in fig.panels:
        x0, y0, x1, y1 = p.box
        ix0, iy0, ix1, iy1 = (int(round(v)) for v in p.box)
        if p.image is not None:
            img = _resample(p.image, max(ix1 - ix0, 1), max(iy1 - iy0, 1))
            canvas.paste(Image.fromarray(img).convert("RGB"), (ix0, iy0))
        if p.title:
            text(((x0 + x1) / 2, y0 - TITLE_GAP_PX), p.title, title_font,
                 "ms")
        if not p.axis_on:
            continue

        def px(x, y):
            (a, b), (c, d) = p.xlim, p.ylim
            return (x0 + (x - a) / (b - a) * (x1 - x0),
                    y1 - (y - c) / (d - c) * (y1 - y0))

        for b in p.bars:
            (u0, v0), (u1, v1) = px(b.left, 0.0), px(b.right, b.height)
            draw.rectangle([min(u0, u1), min(v0, v1), max(u0, u1),
                            max(v0, v1)], fill=_rgb(b.color))
        for b in p.bars:
            if b.yerr is not None:
                draw.line([px(b.centre, b.height - b.yerr),
                           px(b.centre, b.height + b.yerr)], fill="black",
                          width=max(1, round(1.5 * PT)))
        for ln in p.lines:
            pts = [px(x, y) for x, y in zip(ln.x, ln.y)]
            if len(pts) > 1:
                draw.line(pts, fill=_rgb(ln.color), width=round(1.5 * PT))
            r = 3.0 * PT  # markersize 6 pt
            for u, v in pts if ln.marker == "o" else ():
                draw.ellipse([u - r, v - r, u + r, v + r], fill=_rgb(ln.color))
        draw.rectangle([ix0, iy0, ix1, iy1], outline="black")
        for v, s in p.xticks:
            u, _ = px(v, p.ylim[0])
            draw.line([(u, iy1), (u, iy1 + 5)], fill="black")
            text((u, iy1 + 7), s, tick_font, "ma")
        for v, s in p.yticks:
            _, w = px(p.xlim[0], v)
            draw.line([(ix0 - 5, w), (ix0, w)], fill="black")
            text((ix0 - 7, w), s, tick_font, "rm")
        if p.yoffset:
            text((ix0, iy0 - 2), p.yoffset, tick_font, "lb")
        if p.xlabel:
            text(((x0 + x1) / 2, iy1 + 26), p.xlabel, tick_font, "ma")
        for k, (label, colour) in enumerate(p.legend):
            v = iy0 + 12 + 18 * k
            draw.rectangle([ix1 - 150, v - 5, ix1 - 130, v + 5],
                           fill=_rgb(colour))
            text((ix1 - 124, v), label, tick_font, "lm")
    return np.asarray(canvas, dtype=np.uint8).copy()


def _save(out_path: str, img):
    from vbr_tpu_torch.viewer.headless import save_png

    save_png(out_path, img)


def plot_mask_comparison(
    masks_by_model: dict,  # {"KNN": (C, H, W), "MOG": ..., "MOG2": ...}
    out_path: str = "plots/background_models_mask_comparisons.png",
):
    """Cameras × models grid of extracted foreground masks."""
    _save(out_path, _rasterise(mask_comparison_figure(masks_by_model)))


def plot_intrinsic_results(
    runs: Sequence[dict],
    out_path: str = "plots/intrinsic_params_runs_comparison.png",
):
    """Compare calibration runs: mean/per-view errors + fx/fy/cx/cy ± std.

    Each run dict: {"label", "rms", "per_view_errors", "K", "intrinsic_std"}.
    """
    _save(out_path, _rasterise(intrinsic_results_figure(runs)))


# ---------------------------------------------------------------------------
# the mesh snapshot
# ---------------------------------------------------------------------------


def mesh_projection(lo, hi, elev=20.0, azim=-60.0) -> np.ndarray:
    """The 4×4 f64 projection of matplotlib's ``Axes3D.get_proj`` for axis
    limits ``lo``..``hi`` (x, y, z), ``view_init(elev, azim)``, roll 0,
    vertical z, box aspect (4, 4, 3), perspective, focal length 1."""
    aspect = np.asarray(MESH_BOX_ASPECT, np.float64)
    aspect = aspect * (1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect))
    d = (np.asarray(hi, np.float64) - np.asarray(lo, np.float64)) / aspect
    world = np.array([[1 / d[0], 0, 0, -lo[0] / d[0]],
                      [0, 1 / d[1], 0, -lo[1] / d[1]],
                      [0, 0, 1 / d[2], -lo[2] / d[2]],
                      [0, 0, 0, 1]], np.float64)
    R = 0.5 * aspect
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = R + MESH_DIST * ps
    norm_e = np.deg2rad((elev + 180) % 360 - 180)
    V = np.array([0.0, 0.0, -1.0 if abs(norm_e) > np.pi / 2 else 1.0])
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(V, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    eye_focal = R + MESH_DIST * ps * 1.0  # focal length 1
    Mr, Mt = np.eye(4), np.eye(4)
    Mr[:3, :3] = [u, v, w]
    Mt[:3, -1] = -eye_focal
    view = np.dot(Mr, Mt)
    zf, zb = -MESH_DIST, MESH_DIST
    proj = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                     [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)],
                     [0, 0, -1, 0]], np.float64)
    return np.dot(proj, np.dot(view, world))


def _display_map():
    """(scale, shift) of the 3D axes' 2-D data → figure pixels (x right,
    y down): the view limits onto the axes box."""
    lo_v, hi_v = MESH_VIEW
    a0, a1 = (f * MESH_FIG_PX for f in MESH_AXES_FRAC)
    scale = (a1 - a0) / (hi_v - lo_v)
    return scale, a0 - lo_v * scale


def project_vertices(points, M):
    """``proj3d.proj_transform`` of (N, 3) f64 tensor points → (x, y, z)
    f64 tensors: each row of ``M`` as multiplies and adds in column order,
    then divisions by the w row (tensors)."""
    cols = points.unbind(1)

    def row(j):
        acc = cols[0] * float(M[j, 0])
        acc = acc + cols[1] * float(M[j, 1])
        acc = acc + cols[2] * float(M[j, 2])
        return acc + float(M[j, 3])

    w = row(3)
    return row(0) / w, row(1) / w, row(2) / w


def _pane_layer(M, lo, hi) -> np.ndarray:
    """The 3D axes' decorations on white, (H, W, 3) u8 RGB: the three back
    panes with their grid lines, and the axis labels X, Y, Z."""
    Image, ImageDraw, ImageFont = _pil()
    n = MESH_FIG_PX
    canvas = Image.new("RGB", (n, n), "white")
    draw = ImageDraw.Draw(canvas)
    scale, shift = _display_map()
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)

    def to_px(pts):
        P = np.c_[np.asarray(pts, np.float64), np.ones(len(pts))] @ M.T
        x, y = P[:, 0] / P[:, 3], P[:, 1] / P[:, 3]
        return [(float(a), float(n - b)) for a, b in
                zip(x * scale + shift, y * scale + shift)]

    # the eye (where the projection's w vanishes) decides which face of
    # the box is at the back on each axis
    h = np.linalg.inv(M) @ np.array([0.0, 0.0, 1.0, 0.0])
    eye = h[:3] / h[3]
    back = [lo[i] if eye[i] > (lo[i] + hi[i]) / 2 else hi[i] for i in range(3)]
    front = [lo[i] + hi[i] - back[i] for i in range(3)]
    for i in range(3):
        j, k = [a for a in range(3) if a != i]
        corners = []
        for cj, ck in ((lo[j], lo[k]), (hi[j], lo[k]), (hi[j], hi[k]),
                       (lo[j], hi[k])):
            p = np.zeros(3)
            p[i], p[j], p[k] = back[i], cj, ck
            corners.append(p)
        draw.polygon(to_px(corners), fill=PANE_RGB, outline=(204, 204, 204))
        for a, b in ((j, k), (k, j)):  # grid lines along each pane axis
            for t in _max_n_locs(lo[a], hi[a], 5):
                if lo[a] < t < hi[a]:
                    p0, p1 = np.zeros(3), np.zeros(3)
                    p0[i] = p1[i] = back[i]
                    p0[a] = p1[a] = t
                    p0[b], p1[b] = lo[b], hi[b]
                    draw.line(to_px([p0, p1]), fill=(176, 176, 176))
    # each label beside the middle of its axis' edge: x and y on the front
    # edges of the floor, z on the side edge nearest the eye's left
    font = _font(ImageFont, TICK_FONT_PT)
    mid = (lo + hi) / 2
    centre = to_px([mid])[0]
    edges = {"X": (mid[0], front[1], back[2]), "Y": (front[0], mid[1], back[2]),
             "Z": (front[0], back[1], mid[2])}
    for name, p in edges.items():
        u, v = to_px([np.asarray(p)])[0]
        du, dv = u - centre[0], v - centre[1]
        r = max(math.hypot(du, dv), 1e-9)
        draw.text((u + 40 * du / r, v + 40 * dv / r), name, fill="black",
                  font=font, anchor="mm")
    return np.asarray(canvas, dtype=np.uint8).copy()


def render_mesh_snapshot(tris, elev: float = 20.0, azim: float = -60.0,
                         device="cuda"):
    """``plot_mesh_snapshot``'s image → (1000, 1000, 3) u8 RGB tensor on
    the mesh's device (a tensor stays where it is; numpy goes to
    ``device``, which raises when it names a card that is absent)."""
    import torch

    from vbr_tpu_torch.utils.device import resolve_device

    dev = (tris.device if isinstance(tris, torch.Tensor)
           else resolve_device(device))
    t = torch.as_tensor(np.asarray(tris) if not isinstance(tris, torch.Tensor)
                        else tris).to(dev, torch.float64).reshape(-1, 3, 3)
    flat = t.reshape(-1, 3)
    lo, hi = flat.min(0).values.cpu().numpy(), flat.max(0).values.cpu().numpy()
    for i in range(3):  # set_xlim's widening of an empty range
        lo[i], hi[i] = _nonsingular(lo[i], hi[i], expander=0.05)
    M = mesh_projection(lo, hi, elev, azim)
    n = MESH_FIG_PX
    bg = torch.from_numpy(_pane_layer(M, lo, hi)).to(dev).reshape(-1, 3)
    counts, on_edge = _raster_faces(t, M, dev)
    # n layers of tab:blue at alpha a over the background, in 8-bit units:
    # bg·(1−a)^n + 255·blue·(1 − (1−a)^n), both factors from host tables
    # of n (deeper layers change no level); the front face's edge darkens
    # by a·(its width in pixels)
    keep = (1.0 - MESH_ALPHA) ** np.arange(MESH_MAX_LAYERS + 1)
    blue = np.asarray(_rgb(TAB10[0]), np.float64)
    t_keep = torch.from_numpy(keep.astype(np.float32)).to(dev)
    t_fill = torch.from_numpy(
        (blue[None] * (1.0 - keep[:, None])).astype(np.float32)).to(dev)
    layers = counts.clamp(max=MESH_MAX_LAYERS)
    out = bg.to(torch.float32) * t_keep[layers][:, None]
    out = out + t_fill[layers]
    out = torch.where(on_edge[:, None],
                      out * float(np.float32(1.0 - MESH_ALPHA * MESH_EDGE_PX)),
                      out)
    out = torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
    return out.reshape(n, n, 3)


def _project_faces(t, M):
    """(T, 3, 3) f64 faces → their vertices' pixel columns and rows (T, 3)
    (pixel centres at +0.5, rows down) and each face's mean projected
    depth (T,), ``np.average`` of its three: ((z0 + z1) + z2) / 3."""
    import torch

    n = MESH_FIG_PX
    T = t.shape[0]
    x, y, z = project_vertices(t.reshape(-1, 3), M)
    scale, shift = _display_map()
    u = (x * scale + shift).reshape(T, 3)
    v = (float(n) - (y * scale + shift)).reshape(T, 3)
    z = z.reshape(T, 3)
    three = torch.full((), 3.0, dtype=torch.float64, device=t.device)
    return u, v, (z[:, 0] + z[:, 1] + z[:, 2]) / three


def _painter_order(depth):
    """Far to near, ties in the caller's order: ``Poly3DCollection``'s
    ``sorted(..., reverse=True)`` of the mean depths."""
    import torch

    return torch.sort(depth, descending=True, stable=True).indices


def _raster_faces(t, M, dev):
    """Per pixel of the figure: how many faces cover its centre, and
    whether the centre lies within half a pixel of an edge of the front
    face there (the last in painter order)."""
    import torch

    n = MESH_FIG_PX
    T = t.shape[0]
    u, v, depth = _project_faces(t, M)
    order = _painter_order(depth)
    u, v = u[order], v[order]
    ax0, ax1 = (int(round(f * n)) for f in MESH_AXES_FRAC)  # the clip box
    col0 = torch.ceil(u.min(1).values - 0.5).clamp(ax0, ax1).to(torch.int64)
    col1 = torch.floor(u.max(1).values - 0.5).clamp(ax0 - 1, ax1 - 1) \
        .to(torch.int64)
    row0 = torch.ceil(v.min(1).values - 0.5).clamp(ax0, ax1).to(torch.int64)
    row1 = torch.floor(v.max(1).values - 0.5).clamp(ax0 - 1, ax1 - 1) \
        .to(torch.int64)
    nx = (col1 - col0 + 1).clamp(min=0)
    ny = (row1 - row0 + 1).clamp(min=0)
    # edge functions of each face, oriented so its inside is positive
    ea = [(u[:, k], v[:, k], u[:, (k + 1) % 3] - u[:, k],
           v[:, (k + 1) % 3] - v[:, k]) for k in range(3)]
    area = ea[0][2] * ea[1][3] - ea[0][3] * ea[1][2]
    sign = torch.where(area < 0, -1.0, 1.0).to(torch.float64)
    nx = torch.where(area != 0, nx, torch.zeros_like(nx))
    per = nx * ny
    counts = torch.zeros(n * n, dtype=torch.int64, device=dev)
    on_edge = torch.zeros(n * n, dtype=torch.bool, device=dev)
    total = int(per.sum())
    if not total:
        return counts, on_edge
    # one fragment per (face, pixel of its box), in painter order
    face = torch.repeat_interleave(torch.arange(T, device=dev), per)
    start = torch.cumsum(per, 0) - per
    local = torch.arange(total, device=dev) - start[face]
    pc = col0[face] + local % nx[face]
    pr = row0[face] + torch.div(local, nx[face], rounding_mode="floor")
    cx = pc.to(torch.float64) + 0.5
    cy = pr.to(torch.float64) + 0.5
    inside = torch.ones(total, dtype=torch.bool, device=dev)
    near = torch.zeros(total, dtype=torch.bool, device=dev)
    s = sign[face]
    for ox, oy, dx, dy in ea:
        fdx, fdy = dx[face], dy[face]
        e = (fdx * (cy - oy[face]) - fdy * (cx - ox[face])) * s
        # a centre on an edge belongs to the face on its top-left side
        sdy, sdx = fdy * s, fdx * s
        top_left = (sdy < 0) | ((sdy == 0) & (sdx > 0))
        inside &= (e > 0) | ((e == 0) & top_left)
        # within half a pixel of the edge's line: e² < ¼·|edge|²
        near |= (e * e) < ((fdx * fdx + fdy * fdy) * 0.25)
    pix, face, near = (pr * n + pc)[inside], face[inside], near[inside]
    counts.index_add_(0, pix, torch.ones_like(pix))
    front = torch.full((n * n,), -1, dtype=torch.int64, device=dev)
    front.scatter_reduce_(0, pix, face, reduce="amax")
    # each pixel has one fragment of its front face: its flag, unique writes
    mine = face == front[pix]
    on_edge[pix[mine]] = near[mine]
    return counts, on_edge


def plot_mesh_snapshot(
    tris: np.ndarray,
    out_path: str = "plots/marching_cubes.png",
    elev: float = 20.0,
    azim: float = -60.0,
    device="cuda",
):
    """3D triangle-mesh snapshot (plot_marching_cubes equivalent),
    rasterised on ``device``; only the image comes down."""
    _save(out_path, render_mesh_snapshot(tris, elev, azim, device))
