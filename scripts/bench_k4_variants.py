#!/usr/bin/env python3
"""Time departures from K4's design on one NVIDIA GPU, on the inputs of
``chip_smoke.py`` phase 11.

    python3 scripts/bench_k4_variants.py [--rounds 3] [--out build/k4_variants.json]

Each departure in ``VARIANTS`` is a list of text edits to
``vbr_tpu_torch/csrc/carve_frames.cu``, applied to a copy under
``build/kernels/k4_variants/``: the source that the port loads carries none
of them, and an edit that no longer matches the source stops the script.
All builds run in parallel.  Then, on phase 11's inputs (``chip_smoke``'s
``seeded_rig``, ``seeded_model`` and ``k4_chunk``), it launches every build
through ``carve_blocked.carve_frames_kernel``, checks each bit-equal to the
plain version, and times each with ``chip_smoke.timed_ms`` in ``--rounds``
rounds that visit the builds in turn, the order reversed every other round.
For each build it also reports ptxas's registers and, from ``cuobjdump
-sass``, how many mask-byte gathers the C = 4, NF = 8 kernel issues before
the first use of one.  Last, it times the design on chunks of 1 to 16 of
the same frames and on an all-empty chunk.  Prints one line per build and
round, then one JSON object; also writes it to ``--out``.  Needs a card;
imports nothing of JAX or ``vbr_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

_FILL_START = "    // inactive and full sub-blocks, while the copies fly"
_COUNT_END = ("      stage = stage + 1 == kStages ? 0 : stage + 1;\n"
              "    }\n")


def _const(name, value, new):
    return (f"constexpr int {name} = {value};", f"constexpr int {name} = {new};")


def _fills_after(src):
    """The fill loop moved after the counted sub-blocks."""
    start = src.index(_FILL_START)
    end = src.index("    int stage = 0;", start)
    fill = src[start:end]
    return [(fill, ""), (_COUNT_END, _COUNT_END + "\n" + fill.rstrip() + "\n")]


_I32_COUNTERS = [
    ("uint32_t cnt[kGroup] = {};", "int cnt[kGroup][4] = {};"),
    ("cnt[i] += (valid && m != 0 ? 1u : 0u) << (8 * e);",
     "cnt[i][e] += valid && m != 0;"),
    ("out[(f0 + i) * (plane / 4)] = __vcmpgeu4(cnt[i], thr4) & kOnes;",
     "out[(f0 + i) * (plane / 4)] ="
     " (uint32_t)(cnt[i][0] >= (int)(thr4 & 0xff))"
     " | (uint32_t)(cnt[i][1] >= (int)(thr4 & 0xff)) << 8"
     " | (uint32_t)(cnt[i][2] >= (int)(thr4 & 0xff)) << 16"
     " | (uint32_t)(cnt[i][3] >= (int)(thr4 & 0xff)) << 24;"),
]

# name -> the edits of that departure (a list of (old, new), or a function
# of the source that returns one); the design: none
VARIANTS = {
    "design: 2 stages, NF = 8 compiled in, packed counters, fills first, "
    "registers for 8 CTAs per SM": [],
    "registers for 6 CTAs per SM": [_const("kMinCtas", 8, 6)],
    "registers for 10 CTAs per SM": [_const("kMinCtas", 8, 10)],
    "no register cap": [_const("kMinCtas", 8, 1)],
    "NF at run time": [_const("kStaticNF", 8, 0)],
    "NF at run time, registers for 6 CTAs per SM": [
        _const("kStaticNF", 8, 0), _const("kMinCtas", 8, 6)],
    "1 stage": [_const("kStages", 2, 1)],
    "3 stages": [_const("kStages", 2, 3)],
    "i32 counters": _I32_COUNTERS,
    "fills after the counted sub-blocks": _fills_after,
    "4-frame groups": [_const("kGroup", 8, 4)],
}


def variant_kernel(cb, CudaKernel, name, edits):
    """K4's ``CudaKernel`` for the source with ``edits`` applied (K4 itself
    for none)."""
    if not edits:
        return cb.K4
    src = cb.K4.source.read_text()
    for old, new in edits(src) if callable(edits) else edits:
        if src.count(old) != 1:
            raise SystemExit(f"bench_k4_variants: edit of {name!r} matches "
                             f"{src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    d = ROOT / "build" / "kernels" / "k4_variants"
    d.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name).strip("_")
    path = d / f"carve_frames_{stem}.cu"
    path.write_text(src)
    for dep in cb.K4.deps:
        shutil.copy(dep, d / dep.name)
    return CudaKernel(str(path), cb.K4.symbol, cb.K4.argtypes,
                      deps=[dep.name for dep in cb.K4.deps])


@contextlib.contextmanager
def launching(cb, kernel):
    """``carve_blocked.carve_frames_kernel`` launches ``kernel`` inside."""
    saved, cb.K4 = cb.K4, kernel
    try:
        yield
    finally:
        cb.K4 = saved


def gathers_before_first_use(lib_path):
    """How many mask-byte loads (``LDG...U8``) the C = 4, NF = 8 kernel of a
    build issues before the first instruction that reads one of them, from
    ``cuobjdump -sass``; None where the kernel or the tool is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except OSError:
        return None
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if "carve_frames_kernel" not in func or "ILi8E" not in func:
            continue
        pending = set()
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", func):
            ins = m.group(1)
            load = re.match(r"(?:@!?U?P\w+\s+)?LDG\S*\.U8\S*\s+(R\d+),", ins)
            if load:
                pending.add(load.group(1))
                continue
            sources = ins.split(",", 1)[1] if "," in ins else ""
            if pending & set(re.findall(r"\bR\d+\b", sources)):
                return len(pending)
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "k4_variants.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_k4_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vbr_tpu_torch.ops import carve_blocked as cb
    from vbr_tpu_torch.ops._cuda import CudaKernel, build_kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = {name: variant_kernel(cb, CudaKernel, name, edits)
              for name, edits in VARIANTS.items()}
    t0 = time.perf_counter()
    build_kernels(list(builds.values()))
    print(f"{len(builds)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    rig = cs.seeded_rig(torch, (486, 644), 490.0)
    model = cs.seeded_model(rig, dev)
    masks8, active, full = cs.k4_chunk(torch, cb, model, rig.seq)
    btab, vt = model._btab, model.rig.views_threshold
    nblk, C = btab.nsuper * btab.nsub, btab.num_cameras

    def carve(kernel, a, f, m):
        with launching(cb, kernel):
            return cb.carve_frames_kernel(btab.pk, a, f, m, views_threshold=vt)

    want = cb.carve_frames_plain(btab.pk, active, full, masks8,
                                 views_threshold=vt)
    flush_buf = torch.empty(8 << 20, dtype=torch.int64, device=dev)
    report = {"card": card, "rounds": args.rounds, "builds": {}}
    for name, k in builds.items():
        got = carve(k, active, full, masks8)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            print(f"FAILED: {name} differs from the plain version",
                  file=sys.stderr)
            return 1
        with launching(cb, k):
            plan = cb.k4_launch_plan(nblk, C, cs.OFFLINE_NF)
        report["builds"][name] = {
            "ms": [], "plan": plan,
            "ptxas": [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln],
            "gathers_before_first_use": gathers_before_first_use(k.lib_path)}
    print(f"all {len(builds)} builds bit-equal to the plain version on the "
          f"production chunk; active {float((active > 0).float().mean()):.4f}"
          f" of {nblk} sub-blocks", flush=True)
    for r in range(args.rounds):
        order = list(builds) if r % 2 == 0 else list(reversed(builds))
        for name in order:
            ms = cs.timed_ms(lambda: carve(builds[name], active, full, masks8),
                             torch, dev, flush=flush_buf.sum)
            report["builds"][name]["ms"].append(ms)
            print(f"  round {r}: {ms:.5f} ms  {name}", flush=True)
    for b in report["builds"].values():
        b["median_ms"] = float(np.median(b["ms"]))

    # where the design's time goes: the same tables and frames as chunks of
    # 1 to 16 frames, and as an all-empty chunk (flags and fills only)
    chunks = {f"NF = {n}": masks8[torch.arange(n, device=dev) % len(masks8)]
              .contiguous() for n in (1, 2, 4, 8, 16)}
    chunks["NF = 8, all masks empty (flags and fills only)"] = (
        torch.zeros_like(masks8))
    report["design_by_input"] = {}
    for what, m in chunks.items():
        a, f = cb.chunk_activity(m, btab, vt)
        got = cb.carve_frames_kernel(btab.pk, a, f, m, views_threshold=vt)
        if not torch.equal(got, cb.carve_frames_plain(btab.pk, a, f, m,
                                                      views_threshold=vt)):
            print(f"FAILED: the design differs on {what}", file=sys.stderr)
            return 1
        ms = cs.timed_ms(lambda: cb.carve_frames_kernel(
            btab.pk, a, f, m, views_threshold=vt), torch, dev,
            flush=flush_buf.sum)
        counted = int(((a > 0) & (f == 0)).sum())
        report["design_by_input"][what] = {"ms": ms,
                                           "counted_sub_blocks": counted}
        print(f"  design {ms:.5f} ms on {what}; {counted} sub-blocks "
              "counted", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
