#!/usr/bin/env python3
"""Time K1 and K4 at camera counts beside the rig's four on one NVIDIA GPU.

    python3 scripts/bench_camera_counts.py [--rounds 2] [--out build/camera_counts.json]

At the production grid's 4096 sub-blocks and 486x644 images, on random
tables (a seventh of the sub-blocks active, one in thirty of those full)
and random half-foreground masks with a view threshold of 3/7 of the
cameras, it times K1 (one frame) and K4 (a chunk of ``chip_smoke``'s
``OFFLINE_NF`` frames) through their wrappers: at C = 4, where the rig's
ring kernel runs, and at the counts of ``chip_smoke.py`` phase 15 and 8,
which take the direct kernel.  At C = 4 it also times a copy of each source
whose launcher sends C = 4 to the direct kernel too (built under
``build/kernels/camera_counts/``), so that both routes meet on one input,
and both routes once more on the production inputs of ``chip_smoke.py``
phases 3 and 11 (the seeded synthetic rig at 128^3: K1 on its main-path
frame, K4 on its 8-frame chunk).
Every launch is first checked bit-equal to the plain version.  Rounds visit
the cases in turn, the order reversed every other round.  Prints one line
per case and round, then one JSON object with each case's median ms and its
bound (bytes: the flags, the tables of the counted sub-blocks, the distinct
mask bytes they address and the outputs, over ``chip_smoke``'s memory
rate; the production inputs' bounds are the ones ``chip_smoke.py``
prints); also writes it to ``--out``.  Needs a card; imports nothing of JAX
or ``vbr_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# text edits that send C = 4 to the direct kernel as well
DIRECT_AT_4 = {
    "K1": ("  return C == kStaticC\n", "  return false && C == kStaticC\n"),
    "K4": ("  if (C == kStaticC && ", "  if (false && C == kStaticC && "),
}


def direct_copy(CudaKernel, kernel, name):
    """``kernel``'s ``CudaKernel`` for its source with DIRECT_AT_4 applied."""
    old, new = DIRECT_AT_4[name]
    src = kernel.source.read_text()
    if src.count(old) != 1:
        raise SystemExit(f"bench_camera_counts: the {name} edit matches "
                         f"{src.count(old)} times: {old!r}")
    d = ROOT / "build" / "kernels" / "camera_counts"
    d.mkdir(parents=True, exist_ok=True)
    path = d / kernel.source.name
    path.write_text(src.replace(old, new))
    for dep in kernel.deps:
        shutil.copy(dep, d / dep.name)
    return CudaKernel(str(path), kernel.symbol, kernel.argtypes,
                      deps=[dep.name for dep in kernel.deps])


@contextlib.contextmanager
def launching(cb, name, kernel):
    """``carve_blocked``'s wrapper of ``name`` launches ``kernel`` inside."""
    saved = getattr(cb, name)
    setattr(cb, name, kernel)
    try:
        yield
    finally:
        setattr(cb, name, saved)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "camera_counts.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_camera_counts: needs an NVIDIA GPU", file=sys.stderr)
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
    direct = {"K1": direct_copy(CudaKernel, cb.K1, "K1"),
              "K4": direct_copy(CudaKernel, cb.K4, "K4")}
    t0 = time.perf_counter()
    build_kernels([cb.K1, cb.K4, *direct.values()])
    print(f"4 builds in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    nblk, H, W, NF = 4096, 486, 644, cs.OFFLINE_NF
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 29)
    active = (torch.rand(nblk, generator=g, device=dev) < 1 / 7).int()
    full = active * (torch.rand(nblk, generator=g, device=dev) < 1 / 30).int()
    counted = (active > 0) & (full == 0)
    n_count, n_full = int(counted.sum()), int((full > 0).sum())
    flush_buf = torch.empty(8 << 20, dtype=torch.int64, device=dev)

    # (kernel, C, route) -> (call, bound ms, launch plan)
    cases = {}
    for name, counts in (("K1", (4, 8) + cs.K1_CAMERA_COUNTS),
                         ("K4", (4, 8) + cs.K4_CAMERA_COUNTS)):
        for C in counts:
            pk = cs.random_tables(torch, dev, cb, g, nblk, C, H, W)
            thr = 3 * C // 7
            mask_bytes = cs.mask_bytes_read(torch, cb, pk, counted, W)
            if name == "K1":
                lcc = torch.randint(-1, W, (1, nblk, cb.BV), generator=g,
                                    device=dev, dtype=torch.int32)
                masks = torch.randint(0, 2, (C, H, W), generator=g,
                                      device=dev, dtype=torch.uint8) * 255
                image = torch.randint(0, 256, (H, W, 3), generator=g,
                                      device=dev, dtype=torch.uint8)
                a = (pk, lcc, active, full, masks, image)
                kw = dict(color_camera=1, views_threshold=thr)

                def call(a=a, kw=kw):
                    return cb.carve_blocked_kernel(*a, **kw)
                want = cb.carve_blocked_plain(*a, **kw)
                n_bytes = (8 * nblk
                           + (n_count * (C + 1) + n_full * 2) * cb.BV * 4
                           + mask_bytes + nblk * cb.BV * 4)
                plan = cb.k1_launch_plan(nblk, C)
            else:
                masks = torch.randint(0, 2, (NF, C, H, W), generator=g,
                                      device=dev, dtype=torch.uint8) * 255
                a = (pk, active, full, masks)

                def call(a=a, thr=thr):
                    return (cb.carve_frames_kernel(*a, views_threshold=thr),)
                want = (cb.carve_frames_plain(*a, views_threshold=thr),)
                n_bytes = (8 * nblk + n_count * C * cb.BV * 4
                           + NF * mask_bytes + NF * nblk * cb.BV)
                plan = cb.k4_launch_plan(nblk, C, NF)
            routes = [(plan["route"], None)]
            if C == 4:
                routes.append(("direct", direct[name]))
            for route, kernel in routes:
                def run(call=call, kernel=kernel, name=name):
                    if kernel is None:
                        return call()
                    with launching(cb, name, kernel):
                        return call()
                got = run()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    print(f"FAILED: {name} with {C} cameras, route {route}, "
                          "differs from the plain version", file=sys.stderr)
                    return 1
                cases[(name, C, route)] = (run, cs.bound(n_bytes, 0)[0],
                                           plan if kernel is None else None)
            del want
    # both routes at C = 4 on the production inputs
    rig = cs.seeded_rig(torch, (H, W), 490.0)
    model = cs.seeded_model(rig, dev)
    btab, vt = model._btab, model.rig.views_threshold
    frame0 = torch.from_numpy(rig.frame0).to(dev)
    m1 = model.masks(frame0)
    a1, f1 = cb.block_activity(m1, vt, btab.allv, btab.ry, btab.rx)
    k1_args = (btab.pk, btab.lcc, a1, f1, m1,
               frame0[btab.color_camera].contiguous())
    k1_kw = dict(color_camera=btab.color_camera, views_threshold=vt)
    m8, a8, f8 = cs.k4_chunk(torch, cb, model, rig.seq)
    production = {
        "K1": (lambda: cb.carve_blocked_kernel(*k1_args, **k1_kw),
               cb.carve_blocked_plain(*k1_args, **k1_kw)),
        "K4": (lambda: (cb.carve_frames_kernel(btab.pk, a8, f8, m8,
                                               views_threshold=vt),),
               (cb.carve_frames_plain(btab.pk, a8, f8, m8,
                                      views_threshold=vt),)),
    }
    for name, (call, want) in production.items():
        for route, kernel in (("ring", None), ("direct", direct[name])):
            def run(call=call, kernel=kernel, name=name):
                if kernel is None:
                    return call()
                with launching(cb, name, kernel):
                    return call()
            got = run()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                print(f"FAILED: {name} on the production input, route "
                      f"{route}, differs from the plain version",
                      file=sys.stderr)
                return 1
            cases[(name, "production", route)] = (run, None, None)

    def label(key):
        name, C, route = key
        return f"{name} {'C=' if isinstance(C, int) else ''}{C} {route}"

    print(f"all {len(cases)} cases bit-equal to the plain version; "
          f"{n_count} of {nblk} sub-blocks counted, {n_full} full",
          flush=True)

    ms = {key: [] for key in cases}
    for r in range(args.rounds):
        order = list(cases) if r % 2 == 0 else list(reversed(cases))
        for key in order:
            t = cs.timed_ms(cases[key][0], torch, dev, flush=flush_buf.sum)
            ms[key].append(t)
            print(f"  round {r}: {label(key)}: {t:.5f} ms", flush=True)
    report = {"card": card, "rounds": args.rounds, "nblk": nblk,
              "image_hw": [H, W], "frames": NF, "counted": n_count,
              "full": n_full, "cases": {}}
    for key, (_, bound_ms, plan) in cases.items():
        med = float(np.median(ms[key]))
        report["cases"][label(key)] = {"ms": ms[key], "median_ms": med,
                                       "bound_ms": bound_ms, "plan": plan}
        print(f"{label(key)}: {med:.5f} ms, bound {bound_ms} ms", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
