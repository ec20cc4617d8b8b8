"""``BENCHMARK.json`` and the files it names, found by name:

  * a configuration is ``configs[].file`` (``benchmark/configs/<name>.json``);
  * a traffic mix is ``benchmark/traffic/<name>.json``, whose ``loop``
    names its module ``benchmark/loops/<loop>.py``;
  * a metric, end-to-end or per-layer, is ``benchmark/metrics/<name>.py``
    with a ``read(run)`` that returns its value, or None where it finds
    nothing to read.

A later change adds a configuration, a mix or a metric as new files and
entries in ``BENCHMARK.json``; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(root: str, bench: dict, name: str) -> dict:
    with open(os.path.join(root, _by_name(bench["configs"], name,
                                          "configuration")["file"])) as f:
        return json.load(f)


def traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def reader(name: str, folder: str = os.path.join(HERE, "metrics")):
    """The ``read`` function of metric ``name``."""
    path = os.path.join(folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones
    (``trace`` False) or its per-layer ones (``trace`` True).  An entry with
    ``workloads`` belongs to those cells; a per-layer entry without it, to
    every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
