#!/usr/bin/env python3
"""Measure the device table builds' suspicion band against f64 on the CPU.

    python3 scripts/check_suspicion_band.py [--edge 128] [--out build/suspicion_band.json]

For each camera of three camera sets (the rig ``artifacts/auto_extrinsics``,
the calibration poses ``artifacts/intrinsics_run`` and the synthetic rig)
at an ``--edge``³ grid over the default bounds and 486x644 images, it
projects every voxel in f32 (``vbr_tpu_torch``'s tensor projection, as the
device builds run it) and in f64 (the host oracle), and prints per camera:
the largest ratio of the f32 error to ``carve._f32_error_px``'s estimate,
the largest f32 error among voxels that project into the image, the share
of voxels the build re-projects in f64 (``_proj_suspicion_chunk``), and
how many voxels whose truncated index or validity f32 flips a fixed 2e-3
px band (``vbr_tpu``'s) would miss, and how many the port's band misses
(must be 0).  Then one JSON object, also written to ``--out``.  Runs on the
CPU (~1 min at 128³); imports nothing of JAX or ``vbr_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vbr_tpu_torch.ops import camera as cam_ops  # noqa: E402
from vbr_tpu_torch.ops import carve  # noqa: E402
from vbr_tpu_torch.utils import synthetic, xmlio  # noqa: E402
from vbr_tpu_torch.utils.config import CameraParams, GridConfig  # noqa: E402

HW = (486, 644)


def camera_sets():
    def load(where):  # camera i → (directory, file name)
        return [CameraParams.from_arrays(*xmlio.load_camera_config(
            *where(i))) for i in range(1, 5)]

    art = os.path.join(ROOT, "artifacts")
    return {
        "auto_extrinsics": load(lambda i: (
            os.path.join(art, "auto_extrinsics"), f"cam{i}_config.xml")),
        "intrinsics_run": load(lambda i: (
            os.path.join(art, "intrinsics_run", f"cam{i}"), "config.xml")),
        "synthetic": synthetic.synthetic_cameras(4),
    }


def flips(x, y, x64, y64):
    """Voxels whose f32 validity or truncated index differs from f64."""
    H, W = HW
    v32 = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    v64 = (y64 >= 0) & (y64 < H) & (x64 >= 0) & (x64 < W)
    with np.errstate(invalid="ignore"):
        same_idx = ((np.trunc(x) == np.trunc(x64))
                    & (np.trunc(y) == np.trunc(y64)))
    return (v32 != v64) | (v64 & ~same_idx)


def band(x, y, ex, ey, z):
    """The suspicious voxels of bands ``ex``/``ey`` px wide."""
    H, W = HW
    with np.errstate(invalid="ignore"):
        fx, fy = x - np.floor(x), y - np.floor(y)
        return ((fx < ex) | (fx > 1 - ex) | (fy < ey) | (fy > 1 - ey)
                | (np.abs(x) < ex) | (np.abs(x - W) < ex) | (np.abs(y) < ey)
                | (np.abs(y - H) < ey) | (np.abs(z) < carve._SUS_Z_EPS))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edge", type=int, default=128)
    ap.add_argument("--out", default="build/suspicion_band.json")
    args = ap.parse_args()
    grid = GridConfig(nx=args.edge, ny=args.edge, nz=args.edge)
    pts64 = grid.voxel_points()
    pts = torch.from_numpy(pts64.astype(np.float32))
    report = {}
    for name, cams in camera_sets().items():
        rows = []
        for cp in cams:
            rvec, tvec, K, dist = carve._camera_f32(cp, "cpu")
            R = cam_ops.rodrigues(rvec)
            uv = cam_ops.project_points_rt(pts, R, tvec, K, dist)
            x, y = uv[:, 0], uv[:, 1]
            Xc = [R[i, 0] * pts[:, 0] + R[i, 1] * pts[:, 1]
                  + R[i, 2] * pts[:, 2] + tvec[i] for i in range(3)]
            ex, ey = (e.double().numpy() for e in carve._f32_error_px(
                pts, Xc, tvec, K, dist, x, y))
            uv64 = cam_ops.project_points(pts64, cp.rvec, cp.tvec, cp.K,
                                          cp.dist)
            x, y = x.double().numpy(), y.double().numpy()
            x64, y64 = uv64[:, 0], uv64[:, 1]
            z = Xc[2].double().numpy()
            with np.errstate(invalid="ignore", divide="ignore"):
                near = ((np.abs(x64) < 1e4) & (np.abs(y64) < 1e4)
                        & (np.abs(z) > carve._SUS_Z_EPS))
                err = np.maximum(np.abs(x - x64), np.abs(y - y64))
                ratio = np.maximum(np.abs(x - x64) / ex, np.abs(y - y64) / ey)
            inside = near & (x64 > -1) & (x64 < HW[1] + 1) & (y64 > -1) \
                & (y64 < HW[0] + 1)
            flip = flips(x, y, x64, y64)
            fixed = band(x, y, carve._SUS_EPS, carve._SUS_EPS, z)
            port = carve._proj_suspicion_chunk(
                *(torch.from_numpy(a.astype(np.float32))
                  for a in grid.axis_ranges()),
                rvec, tvec, K, dist, HW)[3].numpy()
            rows.append({
                "max_error_over_estimate": float(np.nanmax(ratio[near])),
                "max_error_in_image_px": float(np.nanmax(err[inside])),
                "suspicious_share": float(port.mean()),
                "fixed_band_share": float(fixed.mean()),
                "missed_by_fixed_band": int((flip & ~fixed).sum()),
                "missed_by_port_band": int((flip & ~port).sum()),
            })
            print(name, rows[-1], flush=True)
        report[name] = rows
    report["edge"] = args.edge
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f)
    print(json.dumps(report))
    return 0 if all(r["missed_by_port_band"] == 0
                    for v in report.values() if isinstance(v, list)
                    for r in v) else 1


if __name__ == "__main__":
    sys.exit(main())
