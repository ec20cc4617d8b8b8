#!/usr/bin/env python3
"""The offered-rate sweep of an open-loop cell, run once to place its
rate: one set-up, then a window at each rate in turn, each printing the
frames' latency and how late the generator started them.  A rate is
sustained while its median frame starts less than half a period late and
the lateness of its last quarter of frames stays within one period of its
first quarter's (no growing backlog).

    python3 benchmark/sweep.py --workload rig128-live --seed N --seconds 8 \\
        --rates 50 62 75 90 110
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import program, rigdata, spec  # noqa: E402
from benchmark.run import ROOT, log  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: no sweep")
        return 2
    bench = spec.load_benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    config = spec.config(ROOT, bench, cell["config"])
    traffic = spec.traffic(ROOT, cell["traffic"])
    drv = spec.loop(traffic["loop"])
    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize(dev)

    inputs = rigdata.make(ROOT, config, traffic, args.seed, dev)
    model = program.build(config, inputs, dev)
    drv.warm(model, inputs, traffic, sync)
    rows = []
    for rate in args.rates:
        t = dict(traffic, rate_fps=rate)
        rec, _ = drv.window(model, inputs, t, args.seconds, set(), sync)
        f = rec["frames"]
        lat = (f[:, 4] - f[:, 1]) * 1e3
        late = (f[:, 2] - f[:, 1]) * 1e3
        q = max(len(f) // 4, 1)
        growth = float(late[-q:].mean() - late[:q].mean())
        rows.append({"rate_fps": rate, "frames": len(f),
                     "frame_ms_p50": float(np.percentile(lat, 50)),
                     "frame_ms_p95": float(np.percentile(lat, 95)),
                     "late_ms_p50": float(np.percentile(late, 50)),
                     "late_ms_max": float(late.max()),
                     "late_growth_ms": growth,
                     "sustained": bool(
                         growth < 1e3 / rate
                         and np.percentile(late, 50) < 500 / rate),
                     "at": time.strftime("%H:%M:%S")})
        log(json.dumps(rows[-1]))
    ok = [r["rate_fps"] for r in rows if r["sustained"]]
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(dev),
                      "knee_fps": max(ok) if ok else None, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
