"""The reader of ``cleanup_graph_share.live`` on windows made up here: the
share of the window's ``cleanup`` spans that the program's
``cleanup_graph_replays`` counter says replayed a graph, None without the
counter or without spans."""

from types import SimpleNamespace

import pytest

from benchmark import spans, spec
from benchmark.tests import small
from vbr_tpu_torch.utils.profiling import Span

NAME = "cleanup_graph_share.live"


def test_the_reader_is_declared_for_the_live_cell():
    bench = small.bench()
    assert NAME in [m["name"] for m in spec.metrics_of(bench, "rig128-live",
                                                       True)]
    assert NAME not in [m["name"] for m in spec.metrics_of(
        bench, "rig128-offline", True)]
    assert callable(spec.reader(NAME))


def window(n_steps, n_redos, counts):
    """A live window of ``n_steps`` steps, the first ``n_redos`` of them
    redone, each step and redo with its ``cleanup`` span."""
    got, i = [], 0

    def add(name, parent):
        nonlocal i
        got.append(Span(i, name, float(i), float(i) + 0.5, parent, 0, 0))
        i += 1
        return i - 1

    for k in range(n_steps):
        step = add("step", -1)
        for name in ("upload", "masks", "cleanup", "finalize", "carve"):
            add(name, step)
        if k < n_redos:
            redo = add("redo", step)
            for name in ("masks", "cleanup", "finalize"):
                add(name, redo)
    return got, counts


@pytest.mark.parametrize("steps, redos, counts, want", [
    (20, 2, {"cleanup_graph_replays": 22, "redos": 2}, 100.0),
    (20, 0, {"cleanup_graph_replays": 15}, 75.0),
    (20, 2, {"redos": 2}, None),  # no graph: the parent, or no card
    (0, 0, {"cleanup_graph_replays": 3}, None),
])
def test_the_share_of_cleanups_replayed(steps, redos, counts, want,
                                        monkeypatch):
    monkeypatch.setattr(spans, "window",
                        lambda run, traced=False: window(steps, redos, counts))
    assert spec.reader(NAME)(SimpleNamespace()) == want


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.setattr(spans, "window", lambda run, traced=False: None)
    assert spec.reader(NAME)(SimpleNamespace()) is None
