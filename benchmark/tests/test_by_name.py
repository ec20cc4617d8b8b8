"""A configuration, a traffic mix and a metric are new files found by their
names in BENCHMARK.json; no existing file changes for them."""

import json
import os
import shutil

from benchmark import run, spec
from benchmark.tests import small


def test_new_files_are_found_by_name(tmp_path):
    b = small.bench()
    root = tmp_path
    os.makedirs(root / "benchmark" / "configs")
    os.makedirs(root / "benchmark" / "traffic")
    os.makedirs(root / "benchmark" / "metrics")
    cfg = spec.config(run.ROOT, b, "rig128x4")
    cfg = dict(cfg, name="rig64x4", grid=dict(cfg["grid"], nx=64, ny=64,
                                              nz=64))
    (root / "benchmark" / "configs" / "rig64x4.json").write_text(
        json.dumps(cfg))
    mix = dict(spec.traffic(run.ROOT, "live46"), rate_fps=30)
    (root / "benchmark" / "traffic" / "live30.json").write_text(
        json.dumps(mix))
    shutil.copy(os.path.join(spec.HERE, "metrics", "frame_ms_p50.py"),
                root / "benchmark" / "metrics" / "frame_ms_p75.py")
    b["configs"].append({"name": "rig64x4", "source": "x",
                         "file": "benchmark/configs/rig64x4.json",
                         "reduced": ["nx"], "why": "x"})
    b["workloads"].append({"name": "rig64-live30", "config": "rig64x4",
                           "traffic": "live30", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "frame_ms_p75", "unit": "ms",
                            "better": "lower", "bound": 0.1,
                            "source": "host_clock"})
    b["per_layer"].append({"name": "step_host_ms.live30", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "models/visual_hull",
                           "moves": "frame_ms_p75"})
    assert spec.config(str(root), b, "rig64x4")["grid"]["nx"] == 64
    assert spec.traffic(str(root), "live30")["rate_fps"] == 30
    read = spec.reader("frame_ms_p75", str(root / "benchmark" / "metrics"))
    assert callable(read)
    e2e = [m["name"] for m in spec.metrics_of(b, "rig64-live30", False)]
    assert e2e == ["setup_s", "frame_ms_p75"]
    per = [m["name"] for m in spec.metrics_of(b, "rig64-live30", True)]
    assert per == ["step_host_ms.live30"]
    # a per-layer metric without workloads joins every cell reporting the
    # end-to-end metric it moves, the existing cells too
    assert "step_host_ms.live30" in [
        m["name"] for m in spec.metrics_of(b, "rig128-live", True)]


def test_each_cell_finds_its_files():
    b = small.bench()
    for w in b["workloads"]:
        cfg = spec.config(run.ROOT, b, w["config"])
        assert cfg["name"] == w["config"]
        mix = spec.traffic(run.ROOT, w["traffic"])
        assert spec.loop(mix["loop"]).window
        for m in (spec.metrics_of(b, w["name"], False)
                  + spec.metrics_of(b, w["name"], True)):
            assert callable(spec.reader(m["name"]))
