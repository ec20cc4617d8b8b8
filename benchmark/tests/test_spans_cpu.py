"""The readers of the program's own spans and counters
(``benchmark/spans.py`` and the metrics that use it) on the small CPU
cells: each gives a positive value or None, the span readers find their
spans, and the program's ``redos`` counter over a window equals the
harness's ``load.redos``."""

import pytest

from benchmark import spec
from benchmark.tests import small

CELLS = [w["name"] for w in small.bench()["workloads"]]
SPAN_METRICS = ("upload_host_ms.live", "masks_host_ms.live",
                "cleanup_host_ms.live", "finalize_host_ms.live",
                "carve_host_ms.live", "overflow_wait_ms.live",
                "redo_ms.live", "idle_in_launch_share.live",
                "chunks_s.offline", "download_s.offline",
                "copies_s.offline", "colors_s.offline")
NEW = {m["name"]: m for m in small.bench()["per_layer"]
       if m["name"] in SPAN_METRICS}


def test_twelve_readers_are_declared():
    assert len(NEW) == 12
    for m in NEW.values():
        assert len(m["workloads"]) == 1 and callable(spec.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_the_span_readers_read_positive_values(cell, rig, monkeypatch):
    """A traced run on the CPU: every new metric of the cell is positive
    or absent, and each one that reads host spans is present (only the
    idle share needs a device)."""
    from vbr_tpu_torch.utils import profiling

    windows = []
    loop = spec.loop(spec.traffic(rig.root, spec.workload(
        rig.bench, cell)["traffic"])["loop"])
    inner = loop.window

    def window(*a, **k):
        before = profiling.counters().get("redos", 0)
        record, kept = inner(*a, **k)
        windows.append((record, profiling.counters().get("redos", 0)
                        - before))
        return record, kept

    monkeypatch.setattr(loop, "window", window)
    result = rig.execute(cell, trace=1)
    assert result["correct"] is True
    got = result["metrics"]
    mine = [n for n, m in NEW.items() if cell in m["workloads"]]
    assert mine
    for name in mine:
        if NEW[name]["source"] == "host_clock":
            assert name in got, name
        if name in got:
            assert got[name]["value"] > 0, (name, got[name])
    assert "idle_in_launch_share.live" not in got  # no device on the CPU
    # the program's counter over the untraced window is the harness's
    record, redos = windows[0]
    assert redos == result["load"]["redos"] >= 1
    t0, t1 = (record["frames"][0, 2], record["frames"][-1, 4]) if (
        "frames" in record) else (record["calls"][0, 0],
                                  record["calls"][-1, 1])
    counts, lost = profiling.counted(t0, t1)
    assert not lost and counts["redos"] == redos


def test_a_reader_finds_nothing_without_the_recorder(rig, monkeypatch):
    """Where the program has no recorder (a version before it), each span
    reader gives None and does not raise."""
    from benchmark import spans

    monkeypatch.setattr(spans, "_recorder", lambda: None)
    result = rig.execute("rig128-live", trace=1)
    for name in NEW:
        assert name not in result["metrics"]
