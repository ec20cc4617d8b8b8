"""Every cell of BENCHMARK.json end to end on the CPU at a small size: the
one JSON line, its keys, ``correct``, and the exact redo of the burst
frames counted."""

import json

import pytest

from benchmark import check, rigdata, run, spec
from benchmark.tests import small

CELLS = [w["name"] for w in small.bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_cpu_and_prints_one_line(cell, trace, rig,
                                                    capsys):
    result = rig.execute(cell, trace=trace)
    assert run.report(result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["load"]["redos"] >= 1  # the window holds a burst frame
    assert err.strip().splitlines()[-2:] == [
        f"check {k}: 0 (limit 0)" for k in ("occ_diff", "color_diff")]
    wanted = {m["name"] for m in spec.metrics_of(small.bench(), cell,
                                                 bool(trace))}
    if trace:
        # no device on the CPU: only the harness's own spans are read
        assert set(line["metrics"]) <= wanted
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == wanted
        assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert m["value"] > 0


def test_the_live_window_keeps_its_schedule(tmp_path):
    """Frames are due 1/rate apart from the window's start, each starts no
    earlier than due, and latency runs from the due time."""
    result = small.Rig(tmp_path, traffic={"rate_fps": 5}).execute(
        "rig128-live", seed=5, seconds=0.2)
    assert result["attempted"] == 1 and result["load"]["offered_fps"] == 5
    assert result["load"]["late_ms_p50"] >= 0
    assert result["load"]["redos"] == 0  # frame 0 carries no burst


@pytest.mark.parametrize("seed", [3, 2**31 + 7, 2**33 + 1])
@pytest.mark.parametrize("mix", ["live46", "offline428"])
def test_the_checked_frames_hold_a_burst_frame(seed, mix):
    """Each run checks one frame that the program redoes, whatever the
    seed, besides the ones drawn."""
    traffic = spec.traffic(run.ROOT, mix)
    keep = check.kept_frames(seed, traffic, 51)
    F = traffic["video_frames"]
    assert any(rigdata.is_burst(traffic, k % F) for k in keep)
    assert len(keep) >= traffic["check_frames"]
