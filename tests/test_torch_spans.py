"""The recorder of ``vbr_tpu_torch.utils.profiling`` (spans, counters, the
ring, the off switch) and the spans and counters the model's live step
and offline path record, on a small CPU rig."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from vbr_tpu_torch.models import visual_hull as tvh
from vbr_tpu_torch.utils import config as tconfig
from vbr_tpu_torch.utils import profiling
from vbr_tpu_torch.utils import synthetic as tsyn
from vbr_tpu_torch.utils.profiling import Recorder, span


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the recorder -------------------------------------------------------


def test_nesting_parents_and_requests():
    rec = Recorder(64)
    with span("a", rec):
        with span("b", rec):
            with span("c", rec):
                pass
        with span("d", rec):
            pass
    with span("e", rec):
        with span("f", rec):
            pass
    got, overwritten = rec.spans()
    assert not overwritten and rec.dropped == 0
    by = {s.name: s for s in got}
    assert [s.name for s in got] == list("abcdef")  # by index
    assert [s.index for s in got] == list(range(6))
    assert by["a"].parent == -1 and by["e"].parent == -1
    assert by["b"].parent == by["a"].index
    assert by["c"].parent == by["b"].index
    assert by["d"].parent == by["a"].index
    assert by["f"].parent == by["e"].index
    assert {by[n].request for n in "abcd"} == {by["a"].request}
    assert by["e"].request == by["f"].request != by["a"].request
    for s in got:
        assert s.start <= s.end
    assert by["a"].start <= by["b"].start <= by["c"].start
    assert by["c"].end <= by["b"].end <= by["d"].start <= by["a"].end


def test_another_threads_spans_have_their_own_parents():
    rec = Recorder(64)
    done = threading.Event()

    def worker():
        with span("t", rec):
            with span("u", rec):
                pass
        done.set()

    with span("main", rec):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert done.is_set() and not th.is_alive()
    by = {s.name: s for s in rec.spans()[0]}
    assert by["t"].parent == -1 and by["u"].parent == by["t"].index
    assert by["t"].request != by["main"].request
    assert by["t"].thread == by["u"].thread != by["main"].thread


def test_the_ring_wraps_and_counts_what_it_dropped():
    rec = Recorder(4)
    for k in range(6):
        with span(f"s{k}", rec):
            pass
    assert rec.dropped == 2
    got, overwritten = rec.spans()
    assert [s.name for s in got] == ["s2", "s3", "s4", "s5"]
    assert overwritten  # s0 and s1 started inside an unbounded window
    after = got[0].start  # the oldest span kept: nothing lost from here
    got, overwritten = rec.spans(after)
    assert [s.name for s in got] == ["s2", "s3", "s4", "s5"]
    assert not overwritten
    got, _ = rec.spans(got[1].start, got[2].start)
    assert [s.name for s in got] == ["s3", "s4"]


def test_an_open_span_enters_the_ring_when_it_closes():
    rec = Recorder(8)
    with span("outer", rec):
        with span("inner", rec):
            pass
        assert [s.name for s in rec.spans()[0]] == ["inner"]
    assert [s.name for s in rec.spans()[0]] == ["outer", "inner"]


def test_counters_and_their_window():
    rec = Recorder(3)
    rec.count("redos")
    t0 = time.perf_counter()
    rec.count("redos", 2)
    rec.count("host_cleanups")
    assert rec.counters() == {"redos": 3, "host_cleanups": 1}
    assert rec.counted(t0) == ({"redos": 2, "host_cleanups": 1}, False)
    rec.count("redos")  # the first increment leaves the ring
    assert rec.counted(t0)[1] is False
    assert rec.counted()[1] is True
    assert rec.counters()["redos"] == 4


def test_disabled_records_and_counts_nothing(monkeypatch):
    t0 = time.perf_counter()
    before = profiling.counters()
    monkeypatch.setattr(profiling, "enabled", False)
    with span("off"):
        with span("off_inner"):
            pass
    profiling.count("off_counter", 5)
    rec = Recorder(8)
    with span("off", rec):
        pass
    monkeypatch.setattr(profiling, "enabled", True)
    assert [s for s in profiling.spans(t0)[0]
            if s.name.startswith("off")] == []
    assert profiling.counted(t0)[0] == {}
    assert profiling.counters() == before
    assert rec.spans() == ([], False) and rec.dropped == 0


def test_stage_timer_stages_are_spans():
    t0 = time.perf_counter()
    timer = profiling.StageTimer()
    with timer("stage_a"):
        with timer("stage_b", device="cpu"):
            pass
    got = [s for s in profiling.spans(t0)[0] if s.name.startswith("stage")]
    assert [s.name for s in got] == ["stage_a", "stage_b"]
    assert got[1].parent == got[0].index
    assert timer.counts["stage_a"] == timer.counts["stage_b"] == 1


# -- the program's spans on a small CPU rig --------------------------------

C, H, W = 4, 64, 96
GRID = dict(nx=32, ny=32, nz=32, x_min=-900, x_max=1100, y_min=-1050,
            y_max=950, z_min=-1700, z_max=300)
STAGES = ["upload", "masks", "cleanup", "finalize", "carve", "overflow_wait"]


@pytest.fixture(scope="module")
def rig():
    """A 4-camera model on the CPU trained on 6 background frames, three
    frames with a bright box, and a burst frame (a lattice of isolated
    pixels, more components than the device tables hold)."""
    mp = [tconfig.MaskParams(**dict(dataclasses.asdict(p),
                                    figure_threshold=40.0,
                                    inner_threshold=8.0))
          for p in tconfig.DEFAULT_MASK_PARAMS[:C]]
    model = tvh.VisualHull(
        tsyn.synthetic_cameras(C, image_hw=(H, W), f=80.0),
        tconfig.GridConfig(**GRID),
        tconfig.RigConfig(image_height=H, image_width=W), mask_params=mp,
        device="cpu")
    rng = np.random.default_rng(7)
    bg = rng.integers(0, 200, size=(C, 6, H, W, 3), dtype=np.uint8)
    model.train_background(list(bg))
    frames = []
    for ys, xs in ((slice(14, 44), slice(22, 60)),
                   (slice(18, 48), slice(30, 68)),
                   (slice(8, 50), slice(26, 58))):
        f = bg[:, 0].copy()
        f[:, ys, xs] = 255
        frames.append(f)
    burst = frames[1].copy()
    burst[:, ::2, ::2] = 255
    model.process_frame_fast(frames[0])  # tables built outside the tests
    return model, np.stack(frames), burst


def _window(fn):
    """Run ``fn`` → (its spans, its counters' increments)."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    got, overwritten = profiling.spans(t0, t1)
    counts, lost = profiling.counted(t0, t1)
    assert not overwritten and not lost
    return got, counts


def _children(got, parent):
    return [s.name for s in got if s.parent == parent.index]


def test_a_live_step_records_its_stages(rig):
    model, frames, _ = rig
    got, counts = _window(lambda: model.process_frame_fast(frames[1]))
    roots = [s for s in got if s.parent == -1]
    assert [s.name for s in roots] == ["step"]
    step = roots[0]
    assert _children(got, step) == STAGES
    assert {s.request for s in got} == {step.request}
    kids = [s for s in got if s.parent == step.index]
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    assert step.start <= kids[0].start and kids[-1].end <= step.end
    assert "redos" not in counts


def test_a_burst_frame_is_redone_under_its_step(rig):
    model, frames, burst = rig
    got, counts = _window(lambda: model.process_frame_fast(burst))
    step = next(s for s in got if s.name == "step")
    assert _children(got, step) == STAGES + ["redo"]
    redo = next(s for s in got if s.name == "redo")
    # the masks' own upload, then the mask stage
    assert _children(got, redo) == ["upload", "masks", "cleanup", "finalize"]
    assert counts["redos"] == 1 and counts["host_cleanups"] >= 1


def test_an_offline_call_records_its_chunks(rig):
    model, frames, burst = rig
    video = np.concatenate([frames, burst[None]])  # F = 4, NF = 3: padded
    got, counts = _window(
        lambda: model.process_frames_offline(video, frames_per_launch=3))
    roots = [s for s in got if s.parent == -1]
    assert [s.name for s in roots] == ["offline"]
    offline = roots[0]
    assert _children(got, offline) == ["chunk", "chunk", "redo", "colors"]
    chunks = [s for s in got if s.name == "chunk"]
    stages = ["masks", "cleanup", "finalize", "carve", "download", "colors"]
    assert _children(got, chunks[0]) == ["upload"] + stages
    assert _children(got, chunks[1]) == ["upload", "pad"] + stages
    assert {s.request for s in got} == {offline.request}
    assert counts["redos"] == 1 and counts["host_cleanups"] >= 1
    assert counts["color_voxels"] > 0
    assert counts["padded_frames"] == 2


def test_an_offline_call_without_padding_has_no_pad_span(rig):
    model, frames, _ = rig
    got, counts = _window(lambda: model.process_frames_offline(
        frames[:2], frames_per_launch=2, with_colors=False))
    offline = next(s for s in got if s.name == "offline")
    assert _children(got, offline) == ["chunk"]
    assert not {"colors", "pad"} & {s.name for s in got}
    assert not {"color_voxels", "padded_frames"} & set(counts)


def test_the_stream_records_the_step_stages_as_roots(rig):
    model, frames, _ = rig
    got, _ = _window(lambda: list(model.stream(iter(frames[:2]))))
    roots = [s.name for s in got if s.parent == -1]
    assert roots == ["upload", "masks", "cleanup", "finalize", "carve"] * 2


def test_a_trace_holds_the_steps_spans(rig, tmp_path):
    model, frames, _ = rig
    import json

    with profiling.trace(str(tmp_path), name="step"):
        model.process_frame_fast(frames[2])
    events = json.loads((tmp_path / "step.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(STAGES + ["step"]) <= set(spans)
    step = spans["step"]
    for name in STAGES:
        e = spans[name]
        assert step["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= (
            step["ts"] + step["dur"] + 1.0)
