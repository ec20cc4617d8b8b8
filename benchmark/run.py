#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``vbr_tpu_torch`` on one card:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It makes the cell's inputs from the seed on
the card (timed apart), sets the program up and warms it (``setup_s``),
drives the cell's traffic for ``--seconds`` (with ``--trace 1``, then
for the mix's ``trace_seconds`` more under ``torch.profiler``), frees the
program, works the checked frames out again with the plain reference,
and prints the checked numbers beside
their limits as the last lines of standard error and one JSON line as
the last line of standard output.  Without a card, or with fewer cards
than the cell asks for, it exits 2 and prints no result; it exits 3 if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "vbr_tpu")


def forbidden_modules(names) -> list:
    """The top-level names among module names ``names`` that are JAX or
    the JAX package, compared whole (``vbr_tpu_torch`` is not
    ``vbr_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def card_power_limit():
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else None


def to_host(x):
    """A kept output as a CPU tensor."""
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to("cpu")


def execute(bench, cell_name, seed, seconds, trace, device="cuda",
            root=ROOT):
    """Run one cell on ``device`` → the result line's dict (check last).
    The cell's configuration and traffic files are read under ``root``."""
    import numpy as np
    import torch

    from benchmark import check, program, rigdata, spec
    from benchmark import trace as tr

    cell = spec.workload(bench, cell_name)
    config = spec.config(root, bench, cell["config"])
    traffic = spec.traffic(root, cell["traffic"])
    drv = spec.loop(traffic["loop"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    inputs = rigdata.make(root, config, traffic, seed, dev)
    sync()
    log(f"data: {time.perf_counter() - t:.3f} s for {inputs.video.shape[0]} "
        f"video and {inputs.background.shape[1]} background frames of "
        f"{inputs.video.shape[1]} cameras at {inputs.image_hw}")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    model = program.build(config, inputs, dev)
    drv.warm(model, inputs, traffic, sync)
    sync()
    setup_s = time.perf_counter() - t
    log(f"setup: {setup_s:.3f} s")

    redos = program.count_redos(model)
    keep = set(check.kept_frames(seed, traffic, seconds))
    gc.collect()
    record, kept = drv.window(model, inputs, traffic, seconds, keep, sync)
    record["redos"] = redos["redos"]
    kept = [(j, to_host(o), to_host(c)) for j, o, c in kept]
    held = None
    if trace:  # then a window under the profiler, for the device's view
        gc.collect()
        with tr.traced(cuda) as held:
            traced_record, _ = drv.window(model, inputs, traffic,
                                          float(traffic["trace_seconds"]),
                                          set(), sync)
        log(f"host s per call: {drv.host_s(record):.6f} untraced, "
            f"{drv.host_s(traced_record):.6f} traced")
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    reference = check.Reference(config, inputs, dev)
    numbers = check.compare(kept, reference)
    log(f"check: {time.perf_counter() - t:.3f} s over {len(kept)} kept "
        f"frames")
    run = SimpleNamespace(setup_s=setup_s, record=record,
                          trace=held.trace if held else None,
                          trace_record=traced_record if held else None,
                          kept=kept, reference=reference, inputs=inputs,
                          config=config, traffic=traffic)
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, bool(trace)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    frames = record.get("frames")
    calls = record.get("calls")
    attempted = (len(frames) if frames is not None
                 else int(calls[:, 2].sum()))
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if cuda:
        info["card"] = card_power_limit()
    if frames is not None:  # how late the generator started frames
        late = (frames[:, 2] - frames[:, 1]) * 1e3
        load = {"offered_fps": float(traffic["rate_fps"]),
                "late_ms_p50": float(np.percentile(late, 50)),
                "late_ms_max": float(late.max())}
    else:
        load = {"calls": len(calls)}
    load["redos"] = record["redos"]
    log(f"redos: {record['redos']} frames redone exactly after a cleanup "
        f"overflow")
    result = {"correct": None, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": info, "load": load}
    if held is not None:
        info["busy_s"] = tr.covered(held.trace.device_intervals(),
                                    [(held.t0, held.t1)])
        info["window_s"] = held.t1 - held.t0
        result["breakdown"] = tr.breakdown(
            held.trace, drv.intervals(traced_record),
            drv.spans(traced_record))
    result["check"], result["correct"] = check.judged(numbers)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)

    from benchmark import spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    return report(execute(bench, args.workload, args.seed, args.seconds,
                          args.trace))


def report(result) -> int:
    """Print a run's result: refused (3, nothing printed but the reason)
    where JAX or the JAX package is loaded in this process; else the
    checked numbers beside their limits as the last lines of standard
    error and the result as the last line of standard output (0)."""
    bad = forbidden_modules(list(sys.modules))
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    for name, v in result["check"].items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
