#!/usr/bin/env python3
"""Run both packages' automatic extrinsics on phase 20's scene, on the CPU.

    python3 scripts/check_extrinsics_reference.py [--size 486 644] [--cameras 4] [--iters 400] [--out build/extrinsics_reference.json]

Renders ``chip_smoke.extrinsics_scene`` (the committed rig of
``artifacts/auto_extrinsics``, boards over textured backgrounds, a person
frame from ``artifacts/final``) on the CPU, then runs
``vbr_tpu.pipelines.auto_extrinsics.auto_extrinsics`` (its video readers
replaced by readers of the same arrays) and the port's ``auto_extrinsics``
on ``device="cpu"``.  Prints, for each package, every camera's pose error
against the committed rig in the nearer global 180° frame (rad, mm), the
blobs, matches, flips and votes, then the largest pose difference between
the packages, and one JSON object, also written to ``--out``.  This is how
phase 20's bounds (0.01 rad, 25 mm: ``vbr_tpu``'s test bounds) were checked
against what ``vbr_tpu`` itself reaches on the rig's small board.  Needs
JAX and ``vbr_tpu`` (~30 s at full size, single-threaded torch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=(486, 644))
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "extrinsics_reference.json"))
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from vbr_tpu.pipelines import auto_extrinsics as jax_ax
    from vbr_tpu.utils import video as jvio
    from vbr_tpu.utils.config import CameraParams as JaxCameraParams
    from vbr_tpu_torch.pipelines import auto_extrinsics as ax

    torch.set_num_threads(1)
    sc = chip_smoke.extrinsics_scene(torch, torch.device("cpu"),
                                     tuple(args.size), args.cameras)
    store = {}
    for i in range(args.cameras):
        store[f"/rig/cam{i + 1}/checkerboard.avi"] = sc.boards[i]
        store[f"/rig/cam{i + 1}/background.avi"] = sc.backs[i]
        store[f"/rig/cam{i + 1}/video.avi"] = sc.person[i][None]
    jvio.frame_iterator = lambda path: iter(store[path])
    jvio.get_frame = lambda path, index: store[path][index]

    results = {
        "vbr_tpu": jax_ax.auto_extrinsics(
            "/rig", [JaxCameraParams(**dataclasses.asdict(c))
                     for c in sc.cams], photometric_iters=args.iters),
        "vbr_tpu_torch": ax.auto_extrinsics(
            sc.boards, sc.backs, sc.person, sc.cams,
            photometric_iters=args.iters, device="cpu"),
    }
    report = {"size": list(args.size), "cameras": args.cameras,
              "iters": args.iters}
    for name, res in results.items():
        cams = [dataclasses.replace(
            sc.cams[i], rvec_xyz=tuple(np.ravel(c.rvec)),
            tvec_xyz=tuple(np.ravel(c.tvec)))
            for i, c in enumerate(res.cameras)]
        errs, flipped = chip_smoke.pose_errors(cams, sc.cams)
        report[name] = {
            "pose_err_rad": [e[0] for e in errs],
            "pose_err_mm": [e[1] for e in errs], "global_flip": flipped,
            "n_blobs": res.n_blobs, "n_matched": res.n_matched,
            "flips": res.flips,
            "votes": sorted(res.votes.values(), reverse=True)}
        print(f"{name}: rad {[f'{e[0]:.3e}' for e in errs]}, mm "
              f"{[f'{e[1]:.3f}' for e in errs]}, blobs {res.n_blobs}, "
              f"matched {res.n_matched}, flips {res.flips}")
    a, b = results["vbr_tpu"], results["vbr_tpu_torch"]
    report["max_diff_rad"] = max(float(np.abs(np.ravel(x.rvec) - y.rvec)
                                       .max())
                                 for x, y in zip(a.cameras, b.cameras))
    report["max_diff_mm"] = max(float(np.abs(np.ravel(x.tvec) - y.tvec).max())
                                for x, y in zip(a.cameras, b.cameras))
    report["votes_equal"] = a.votes == b.votes
    print(f"port - vbr_tpu: {report['max_diff_rad']:.1e} rad, "
          f"{report['max_diff_mm']:.1e} mm; votes equal: "
          f"{report['votes_equal']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
