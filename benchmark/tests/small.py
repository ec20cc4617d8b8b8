"""The small CPU rig the benchmark's tests share: each configuration and
traffic mix of BENCHMARK.json written anew into a directory of its own and
found there by name, as a run finds the committed ones.  The
configurations are cut to 120×160 pixels, a 32³ grid and 8 background
frames, with the cameras' intrinsics scaled to the image and the mask
thresholds scaled to it (figure 200, inner 8), as ``chip_smoke.py``'s CPU
rehearsal scales them; the mixes to a 24-frame video with a burst in
frames 6 and 18."""

import copy
import json
import os
import shutil

from benchmark import run, spec

IMAGE_HW = (120, 160)
GRID_N = 32
BACKGROUND_FRAMES = 8
TRAFFIC = {"video_frames": 24, "check_frames": 4, "burst_every": 12}


def bench():
    return spec.load_benchmark(run.ROOT)


def scaled_cameras(cameras, from_hw, to_hw):
    """``cameras`` with their intrinsics scaled from ``from_hw`` to
    ``to_hw``."""
    sy, sx = to_hw[0] / from_hw[0], to_hw[1] / from_hw[1]
    out = []
    for cam in cameras:
        K = [list(r) for r in cam["K"]]
        K[0] = [K[0][0] * sx, K[0][1] * sx, K[0][2] * sx]
        K[1] = [K[1][0] * sy, K[1][1] * sy, K[1][2] * sy]
        out.append(dict(cam, K=K))
    return out


class Rig:
    """The benchmark's cells under ``root``: ``image_hw`` and ``grid_n``
    None keep the configured sizes; ``traffic`` changes every mix."""

    def __init__(self, root, image_hw=IMAGE_HW, grid_n=GRID_N,
                 background_frames=BACKGROUND_FRAMES, traffic=None):
        self.root = str(root)
        self.bench = bench()
        for sub in ("configs", "traffic", "data"):
            os.makedirs(os.path.join(self.root, "benchmark", sub),
                        exist_ok=True)
        for c in self.bench["configs"]:
            cfg = copy.deepcopy(spec.config(run.ROOT, self.bench, c["name"]))
            shutil.copy(os.path.join(run.ROOT, cfg["subject"]["silhouettes"]),
                        os.path.join(self.root, cfg["subject"]["silhouettes"]))
            cfg["background"]["frames"] = background_frames
            if image_hw:
                cfg["cameras"] = scaled_cameras(cfg["cameras"],
                                                cfg["image_hw"], image_hw)
                cfg["image_hw"] = list(image_hw)
                cfg["mask_params"] = [
                    dict(p, figure_threshold=200, inner_threshold=8)
                    for p in cfg["mask_params"]]
            if grid_n:
                cfg["grid"].update(nx=grid_n, ny=grid_n, nz=grid_n)
            self._write(c["file"], cfg)
        for w in self.bench["workloads"]:
            mix = {**spec.traffic(run.ROOT, w["traffic"]), **TRAFFIC,
                   **(traffic or {})}
            self._write(f"benchmark/traffic/{w['traffic']}.json", mix)

    def _write(self, rel, obj):
        with open(os.path.join(self.root, rel), "w") as f:
            json.dump(obj, f)

    def execute(self, cell_name, seed=2**31 + 99, seconds=0.4, trace=0):
        return run.execute(self.bench, cell_name, seed, seconds, trace,
                           device="cpu", root=self.root)
