"""``vbr_tpu_torch/pipelines/reports.py`` against
``vbr_tpu/pipelines/reports.py`` (matplotlib) on the CPU.

``vbr_tpu``'s figure is captured by monkeypatching its ``_savefig`` (it
still lays the figure out and saves it; nothing in ``vbr_tpu`` changes).
The port's figure description must carry the same titles, bar heights and
widths, error bars, line data, legend labels, tick labels (the ticks
matplotlib draws), offset text and axis limits, and its PNG the same size.
The mask grid's panel boxes must lie within 2 px of matplotlib's and
their grey levels within ``GREY_MEAN`` levels on average, with at most
``GREY_FAR`` of a panel's pixels more than 64 levels off (matplotlib's
antialiasing filter against the port's area resampling, at the edges of
the masks and their speckle: measured up to 2.23 levels and 1.3 % at the
rig's 486x644, 0.87 and 0.5 % at 120x160).  The mesh snapshot's
projection must match ``proj3d.proj_transform`` under ``ax.get_proj()``
to 1e-9 relative, its face order matplotlib's (where the mean depths do
not tie within 1e-12), and its covered pixels those of ``vbr_tpu``'s
figure re-rendered with the axes off, to IoU ``MESH_IOU`` (measured
0.9968-0.9970 on the meshes here)."""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402

from vbr_tpu.pipelines import reports as jrep  # noqa: E402
from vbr_tpu_torch.ops import marching_cubes as tmc  # noqa: E402
from vbr_tpu_torch.pipelines import reports as trep  # noqa: E402

GREY_MEAN = 3.0
GREY_FAR = 0.02
BOX_PX = 2.0
MESH_IOU = 0.97


@pytest.fixture
def captured(monkeypatch):
    """``vbr_tpu``'s figures as it saves them: {"fig": the last one}."""
    out = {}
    save = jrep._savefig

    def grab(fig, out_path):
        save(fig, out_path)  # lays it out once, draws and writes it
        out["fig"] = fig

    monkeypatch.setattr(jrep, "_savefig", grab)
    yield out
    plt.close("all")


def mpl_description(fig):
    """Per axes of a drawn matplotlib figure: its title, x label, limits,
    the tick labels it draws, the y offset text, bars (left, width,
    height), error bar segments, line data and legend labels."""
    out = []
    for ax in fig.axes:
        leg = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
            "xticks": [t.label1.get_text() for t in ax.xaxis._update_ticks()],
            "yticks": [t.label1.get_text() for t in ax.yaxis._update_ticks()],
            "yoffset": ax.yaxis.get_offset_text().get_text(),
            "bars": [(p.get_x(), p.get_width(), p.get_height())
                     for p in ax.patches],
            "errors": [np.asarray(s) for c in ax.collections
                       for s in c.get_segments()],
            "lines": [(ln.get_xdata(), ln.get_ydata()) for ln in ax.lines],
            "legend": [t.get_text() for t in leg.get_texts()] if leg else []})
    return out


def port_description(fig):
    """The same fields of the port's figure description."""
    out = []
    for p in fig.panels:
        out.append({
            "title": p.title, "xlabel": p.xlabel, "xlim": p.xlim,
            "ylim": p.ylim, "xticks": [s for _, s in p.xticks],
            "yticks": [s for _, s in p.yticks], "yoffset": p.yoffset,
            "bars": [(b.left, b.width, b.height) for b in p.bars],
            "errors": [np.array([[b.centre, b.height - b.yerr],
                                 [b.centre, b.height + b.yerr]])
                       for b in p.bars if b.yerr is not None],
            "lines": [(ln.x, ln.y) for ln in p.lines],
            "legend": [label for label, _ in p.legend]})
    return out


def assert_same_description(mpl, port):
    assert len(mpl) == len(port)
    for a, b in zip(mpl, port):
        for key in ("title", "xlabel", "xticks", "yticks", "yoffset",
                    "legend"):
            assert a[key] == b[key], key
        assert tuple(map(float, a["xlim"])) == tuple(b["xlim"])
        assert tuple(map(float, a["ylim"])) == tuple(b["ylim"])
        assert [tuple(map(float, t)) for t in a["bars"]] == b["bars"]
        assert len(a["errors"]) == len(b["errors"])
        for s, t in zip(a["errors"], b["errors"]):
            np.testing.assert_array_equal(s, t)
        assert len(a["lines"]) == len(b["lines"])
        for (x0, y0), (x1, y1) in zip(a["lines"], b["lines"]):
            np.testing.assert_array_equal(np.asarray(x0, float), x1)
            np.testing.assert_array_equal(np.asarray(y0, float), y1)


def png_size(path):
    with Image.open(path) as im:
        return im.size


def seeded_runs(seed):
    """One or two calibration runs with seeded values spanning scales and
    an offset axis (per-view errors near 1000 px), zero stds included."""
    rng = np.random.default_rng(seed)
    runs = []
    for i in range(1 + seed % 2):
        K = np.array([[rng.uniform(300, 3000), 0, rng.uniform(100, 900)],
                      [0, rng.uniform(300, 3000), rng.uniform(100, 900)],
                      [0, 0, 1.0]])
        scale = 10 ** rng.uniform(-3, 1)
        views = int(rng.integers(1, 40))
        pv = rng.uniform(0.1, 1, views) * scale + (1000 if seed == 3 else 0)
        runs.append(dict(label=["all views", "after discard"][i],
                         rms=float(rng.uniform(0.05, 2) * scale),
                         per_view_errors=pv, K=K,
                         intrinsic_std=rng.uniform(0, 30, 9) * (seed % 3 > 0)))
    return runs


@pytest.mark.parametrize("seed", range(6))
def test_intrinsics_figure_carries_vbr_tpus_data(seed, captured, tmp_path):
    runs = seeded_runs(seed)
    jpath, tpath = tmp_path / "j.png", tmp_path / "t.png"
    jrep.plot_intrinsic_results(runs, str(jpath))
    trep.plot_intrinsic_results(runs, str(tpath))
    assert_same_description(mpl_description(captured["fig"]),
                            port_description(
                                trep.intrinsic_results_figure(runs)))
    assert png_size(jpath) == png_size(tpath) == (1800, 500)


def test_intrinsics_tick_rules_on_many_seeds(monkeypatch):
    """The locator, formatter and autoscale rules over 16 more seeded
    runs (laid out and drawn, not written): every description field
    equal."""
    figs = []

    def layout(fig, out_path):
        fig.tight_layout()
        fig.canvas.draw()
        figs.append(fig)

    monkeypatch.setattr(jrep, "_savefig", layout)
    for seed in range(6, 22):
        runs = seeded_runs(seed)
        jrep.plot_intrinsic_results(runs)
        assert_same_description(mpl_description(figs[-1]),
                                port_description(
                                    trep.intrinsic_results_figure(runs)))
        plt.close(figs[-1])


def seeded_masks(C, H, W, seed=1):
    """KNN/MOG/MOG2-like masks: an ellipse per model and camera, speckle,
    and MOG's camera 2 constant (it draws black)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    masks = {}
    for k, name in enumerate(["KNN", "MOG", "MOG2"]):
        m = np.zeros((C, H, W), np.uint8)
        for c in range(C):
            m[c][((yy - H / 2 - 5 * k) ** 2 / (H * H / 16)
                  + (xx - W / 2 + 7 * c) ** 2 / (W * W / 64)) < 1] = 255
            m[c][rng.random((H, W)) < 0.01] = 255
        masks[name] = m
    if C > 1:
        masks["MOG"][1] = 7
    return masks


@pytest.mark.parametrize("C, H, W", [(2, 120, 160), (4, 486, 644),
                                     (1, 200, 100)])
def test_mask_grid_matches_matplotlib(C, H, W, captured, tmp_path):
    masks = seeded_masks(C, H, W)
    jpath, tpath = tmp_path / "j.png", tmp_path / "t.png"
    jrep.plot_mask_comparison(masks, str(jpath))
    trep.plot_mask_comparison(masks, str(tpath))
    assert png_size(jpath) == png_size(tpath) == (1800, 500 * C)
    fig = captured["fig"]
    desc = trep.mask_comparison_figure(masks)
    assert [p.title for p in desc.panels] == [ax.get_title()
                                              for ax in fig.axes]
    ref = np.asarray(Image.open(jpath).convert("RGB"), np.int32)
    got = np.asarray(Image.open(tpath).convert("RGB"), np.int32)
    fig_h = 500 * C
    for ax, p in zip(fig.axes, desc.panels):
        e = ax.get_window_extent()
        box = (e.x0, fig_h - e.y1, e.x1, fig_h - e.y0)
        assert max(abs(a - b) for a, b in zip(box, p.box)) <= BOX_PX
        x0, y0, x1, y1 = (int(round(v)) for v in p.box)
        inner = np.s_[y0 + 2:y1 - 2, x0 + 2:x1 - 2]
        d = np.abs(ref[inner][..., 0] - got[inner][..., 0])
        assert d.mean() <= GREY_MEAN
        assert (d > 64).mean() <= GREY_FAR
        assert (got[inner] == got[inner][..., :1]).all()  # grey
    if C > 1:  # the constant mask is black in both
        x0, y0, x1, y1 = (int(round(v)) for v in desc.panels[4].box)
        assert (got[y0 + 2:y1 - 2, x0 + 2:x1 - 2] == 0).all()
        assert (ref[y0 + 2:y1 - 2, x0 + 2:x1 - 2] == 0).all()


@functools.lru_cache(maxsize=None)
def _mesh(seed):
    """A marching-cubes mesh of two seeded ellipsoids (f32, world mm)."""
    rng = np.random.default_rng(seed)
    n = 20
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    c = rng.uniform(7, 12, 3)
    r = rng.uniform(15, 60, 3)
    vol = ((g - c) ** 2 / r).sum(-1) < 1
    vol |= ((g - c - rng.uniform(-4, 4, 3)) ** 2).sum(-1) < 9
    return tmc.extract_mesh(vol, rng.uniform(-800, 0, 3),
                            rng.uniform(10, 40, 3), device="cpu")[0]


@pytest.mark.parametrize("seed, elev, azim", [(0, 20.0, -60.0),
                                              (1, 35.0, 30.0),
                                              (2, -15.0, 140.0)])
def test_mesh_snapshot_matches_matplotlib(seed, elev, azim, captured,
                                          tmp_path):
    tris = _mesh(seed)
    jpath, tpath = tmp_path / "j.png", tmp_path / "t.png"
    jrep.plot_mesh_snapshot(tris, str(jpath), elev, azim)
    trep.plot_mesh_snapshot(tris, str(tpath), elev, azim, device="cpu")
    assert png_size(jpath) == png_size(tpath) == (1000, 1000)
    fig = captured["fig"]
    ax = fig.axes[0]
    M = ax.get_proj()
    lo = tris.reshape(-1, 3).min(0).astype(np.float64)
    hi = tris.reshape(-1, 3).max(0).astype(np.float64)
    Mp = trep.mesh_projection(lo, hi, elev, azim)
    np.testing.assert_allclose(Mp, M, rtol=1e-12, atol=1e-15)
    P = tris.reshape(-1, 3).astype(np.float64)
    ref = proj3d.proj_transform(P[:, 0], P[:, 1], P[:, 2], M)
    got = trep.project_vertices(torch.from_numpy(P), Mp)
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-9 * np.abs(a).max()
    # the face order: matplotlib's sorted(..., reverse=True) of np.average
    zs = np.asarray(ref[2]).reshape(-1, 3)
    keys = [np.average(z) for z in zs]
    want = [i for _, i in sorted(((k, i) for i, k in enumerate(keys)),
                                 key=lambda x: x[0], reverse=True)]
    _, _, depth = trep._project_faces(
        torch.from_numpy(tris.astype(np.float64)), Mp)
    order = trep._painter_order(depth).numpy()
    k = np.asarray(keys)
    differ = np.nonzero(order != np.asarray(want))[0]
    assert sorted(order.tolist()) == list(range(len(tris)))
    assert all(abs(k[order[i]] - k[want[i]]) <= 1e-12 * np.abs(k).max()
               for i in differ)
    # covered pixels against the figure with the axes off
    ax.set_axis_off()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].astype(np.int32)
    one_layer = 255 * 0.1 + np.array([31, 119, 180]) * 0.9
    ref_cov = img.sum(-1) < (255 * 3 + one_layer.sum()) / 2
    counts, _ = trep._raster_faces(torch.from_numpy(tris.astype(np.float64)),
                                   Mp, "cpu")
    cov = counts.reshape(1000, 1000).numpy() > 0
    iou = (cov & ref_cov).sum() / (cov | ref_cov).sum()
    assert iou >= MESH_IOU, iou
    # the PNG is the tab:blue composite where covered, the panes elsewhere
    png = np.asarray(Image.open(tpath))
    assert (png[cov][:, 2] > png[cov][:, 0] + 60).all()


def test_mesh_snapshot_is_one_image_for_tensor_and_numpy():
    tris = _mesh(0)
    a = trep.render_mesh_snapshot(tris, device="cpu")
    b = trep.render_mesh_snapshot(torch.from_numpy(tris))
    assert a.shape == (1000, 1000, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b)


def test_mesh_snapshot_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        trep.plot_mesh_snapshot(_mesh(0), str(tmp_path / "m.png"))


def test_without_pil_the_figures_raise_naming_pillow(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        trep.plot_intrinsic_results(seeded_runs(0), str(tmp_path / "i.png"))
    assert not os.path.exists(tmp_path / "i.png")
    # the description itself needs no PIL
    assert trep.intrinsic_results_figure(seeded_runs(0)).size == (1800, 500)
