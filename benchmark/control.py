#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place, every floating stage one type below what the configuration states
(the MOG model in bfloat16 for float32, the projections in float32 for
float64), judged by the same comparison on the frames a run of the cell
checks.  A comparison that this does not fail is no check.

    python3 benchmark/control.py --workload rig128-live --seconds 30 \\
        --seeds 11 12 13

Prints one JSON line per seed with each compared number, and exits 1 if
any seed's control came out within every limit.  The benchmark's own runs
do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import check, rigdata, spec  # noqa: E402
from benchmark.run import ROOT, log  # noqa: E402


def control_numbers(bench, cell_name, seed, seconds, device,
                    root=ROOT) -> dict:
    """The compared numbers of the control against the reference, on the
    frames a run of ``cell_name`` with this seed and window checks."""
    import torch

    cell = spec.workload(bench, cell_name)
    config = spec.config(root, bench, cell["config"])
    traffic = spec.traffic(root, cell["traffic"])
    dev = torch.device(device)
    inputs = rigdata.make(root, config, traffic, seed, dev)
    frames = sorted({k % len(inputs.video)
                     for k in check.kept_frames(seed, traffic, seconds)})
    low = check.Reference(config, inputs, dev,
                          check.lower_precision(config["precision"]))
    kept = [(j, *(t.cpu() for t in low.outputs(j))) for j in frames]
    del low
    return check.compare(kept, check.Reference(config, inputs, dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: no control")
        return 2
    bench = spec.load_benchmark(ROOT)
    failed_all = True
    for seed in args.seeds:
        numbers = control_numbers(bench, args.workload, seed, args.seconds,
                                  "cuda")
        _, within = check.judged(numbers)
        failed_all &= not within
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers, "fails": not within}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
