#!/usr/bin/env python3
"""The recorder of ``vbr_tpu_torch.utils.profiling`` on a card: what it
costs, and whether the program's spans account for its time.

    python3 scripts/bench_spans.py cost
    python3 scripts/bench_spans.py cell --workload rig128-live --seed N \\
        --seconds 51
    python3 scripts/bench_spans.py onoff --seed N --pairs 6 --seconds 15

from the root of a checkout, with a CUDA card (``--device cpu`` and a
``--root`` holding small configuration and traffic files rehearse it on
the CPU).  Each prints one JSON line.

* ``cost``: µs per span on this host, over ``--n`` nests of a live step's
  spans (a root and six children), with the recorder on and off, beside
  the same loop without spans.
* ``cell``: one traced run of a benchmark cell (``benchmark/run.py``'s
  ``execute``); then, for each of its windows, the recorder's spans summed
  by parent and name per frame (live) or per call (offline) beside the
  harness's host time per call, and the program's ``redos`` counter over
  the window beside the harness's count of redos.
* ``onoff``: one model of the live cell, ``--pairs`` windows of its
  traffic in which the recorder is on for every other frame; per window
  the host ms per call of the frames with it on and off, and the change.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vbr_tpu_torch.utils import profiling  # noqa: E402
from vbr_tpu_torch.utils.profiling import span  # noqa: E402

STAGES = ("upload", "masks", "cleanup", "finalize", "carve", "overflow_wait")


def cost(n: int) -> dict:
    """µs per span, recorder on and off, and µs per nest without spans."""
    def nests():
        t = time.perf_counter()
        for _ in range(n):
            with span("step"):
                for name in STAGES:
                    with span(name):
                        pass
        return (time.perf_counter() - t) * 1e6 / n

    def bare():
        t = time.perf_counter()
        for _ in range(n):
            for _name in STAGES:
                pass
        return (time.perf_counter() - t) * 1e6 / n

    out = {"n": n, "spans_per_nest": 1 + len(STAGES), "on": [], "off": [],
           "bare": []}
    for on in (True, False, True, False, True, False):
        profiling.enabled = on
        out["on" if on else "off"].append(nests())
        out["bare"].append(bare())
    profiling.enabled = True
    k = out["spans_per_nest"]
    base = min(out["bare"])
    out["us_per_span_on"] = (min(out["on"]) - base) / k
    out["us_per_span_off"] = (min(out["off"]) - base) / k
    return out


def _bounds(record):
    f = record.get("frames")
    if f is not None:
        return float(f[0, 2]), float(f[-1, 4]), len(f)
    c = record["calls"]
    return float(c[0, 0]), float(c[-1, 1]), len(c)


def split(record, harness_redos) -> dict:
    """The recorder's view of one window: ms per frame or call of each
    (parent, name) of span, and its ``redos`` counter beside the
    harness's."""
    t0, t1, units = _bounds(record)
    got, overwritten = profiling.spans(t0, t1)
    counts, lost = profiling.counted(t0, t1)
    named = {s.index: s.name for s in got}
    ms = {}
    for s in got:
        key = f"{named.get(s.parent, '-')}/{s.name}"
        ms[key] = ms.get(key, 0.0) + (s.end - s.start) * 1e3 / units
    f = record.get("frames")
    c = record.get("calls")
    host = (f[:, 3] - f[:, 2]) if f is not None else (c[:, 1] - c[:, 0])
    root = "step" if f is not None else "offline"
    children = sum(v for k, v in ms.items() if k.startswith(root + "/"))
    return {"units": units, "spans": len(got), "overwritten": overwritten,
            "lost_counts": lost, "host_ms_per_unit": float(host.mean()) * 1e3,
            "root_ms_per_unit": ms.get(f"-/{root}"),
            "children_ms_per_unit": children,
            "children_share_of_root": (children / ms[f"-/{root}"]
                                       if ms.get(f"-/{root}") else None),
            "ms_per_unit": dict(sorted(ms.items())),
            "redos_program": counts.get("redos", 0),
            "redos_harness": harness_redos,
            "host_cleanups": counts.get("host_cleanups", 0)}


def cell(args) -> dict:
    """A traced run of the cell, and the recorder's split of each
    window."""
    from benchmark import program, run, spec

    bench = spec.load_benchmark(args.root)
    traffic = spec.traffic(args.root,
                           spec.workload(bench, args.workload)["traffic"])
    loop = spec.loop(traffic["loop"])
    inner, count_redos = loop.window, program.count_redos
    harness, windows = [], []

    def counted(model):
        harness.append(count_redos(model))
        return harness[-1]

    def window(*a, **k):
        before = harness[-1]["redos"] if harness else 0
        record, kept = inner(*a, **k)
        windows.append((record, harness[-1]["redos"] - before
                        if harness else None))
        return record, kept

    loop.window, program.count_redos = window, counted
    try:
        result = run.execute(bench, args.workload, args.seed, args.seconds,
                             1, device=args.device, root=args.root)
    finally:
        loop.window, program.count_redos = inner, count_redos
    out = {"workload": args.workload, "seed": args.seed,
           "correct": result["correct"], "load": result["load"],
           "device": result["device"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    for name, (record, redos) in zip(("untraced", "traced"), windows):
        out[name] = split(record, redos)
    return out


def onoff(args) -> dict:
    """Live windows in which the recorder is on for every other frame
    (off first in every other window): per window, the mean host ms per
    call of its frames with the recorder on and off, burst frames left
    out, and their ratio less one.  Alternating frame by frame cancels the
    host's drift between windows."""
    import numpy as np
    import torch

    from benchmark import program, rigdata, spec

    bench = spec.load_benchmark(args.root)
    cell = spec.workload(bench, args.workload)
    config = spec.config(args.root, bench, cell["config"])
    traffic = spec.traffic(args.root, cell["traffic"])
    drv = spec.loop(traffic["loop"])
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    inputs = rigdata.make(args.root, config, traffic, args.seed, dev)
    model = program.build(config, inputs, dev)
    drv.warm(model, inputs, traffic, sync)
    step = model.process_frame_fast
    windows = []
    for w in range(args.pairs):
        on_first, states = w % 2 == 0, []

        def toggled(*a, **k):
            states.append((len(states) % 2 == 0) == on_first)
            profiling.enabled = states[-1]
            try:
                return step(*a, **k)
            finally:
                profiling.enabled = True

        model.process_frame_fast = toggled
        record, _ = drv.window(model, inputs, traffic, args.seconds, set(),
                               sync)
        f = record["frames"]
        host = (f[:, 3] - f[:, 2]) * 1e3
        on = np.asarray(states)
        # a redone frame takes tens of ms more, whichever side it falls on
        plain = ~np.array([rigdata.is_burst(traffic, int(j)) for j in f[:, 0]])
        a, b = host[on & plain], host[~on & plain]
        windows.append({"frames": len(host), "burst_frames_left_out": int(
            (~plain).sum()), "on_host_ms": float(a.mean()),
            "off_host_ms": float(b.mean()),
            "change": float(a.mean() / b.mean() - 1),
            "change_of_medians": float(np.median(a) / np.median(b) - 1)})
    del model.process_frame_fast  # the class's method again
    changes = [w["change"] for w in windows]
    return {"workload": args.workload, "seed": args.seed,
            "seconds": args.seconds, "windows": windows,
            "change_median": statistics.median(changes),
            "change_range": [min(changes), max(changes)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("cost", "cell", "onoff"))
    ap.add_argument("--workload", default="rig128-live")
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    if args.what == "cost":
        out = cost(args.n)
    elif args.what == "cell":
        out = cell(args)
    else:
        out = onoff(args)
    if args.device == "cuda":
        import torch

        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
