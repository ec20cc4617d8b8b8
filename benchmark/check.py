"""What decides ``correct``: the occupancy and colours that the timed path
produced, held against the plain reference worked out again from the same
inputs.

``occ_diff`` counts the voxels whose occupancy differs and ``color_diff``
the voxels whose colour differs (0 off the hull on both sides), over every
kept frame.  The configuration states an exact result (integer and
rounded-after-every-operation arithmetic), so both limits are 0.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference as ref
from benchmark import rigdata, spec

LIMITS = {"occ_diff": 0, "color_diff": 0}
LOWER = {"float64": "float32", "float32": "bfloat16"}


class Reference:
    """The reference side of a cell on ``device``: the background models
    and the projections, built at once, and each video frame's cleaned
    masks and outputs, on demand.  ``precision`` = {"mog": ...,
    "projection": ...} names each stage's floating type."""

    def __init__(self, config, inputs, device, precision=None):
        self.config = config
        self.inputs = inputs
        self.device = torch.device(device)
        self.precision = dict(precision or config["precision"])
        self.grid = config["grid"]
        self.mask_params = config["mask_params"]
        self.views_threshold = config["views_threshold"]
        self.color_camera = config["color_camera"]
        mog = dict(config["mog"], history=inputs.background.shape[1])
        self.mog = mog
        dt = ref.DTYPES[self.precision["mog"]]
        self.models = [
            ref.train_mog(torch.from_numpy(bg).to(self.device), mog, dt)
            for bg in inputs.background]
        self.proj = ref.Projections(inputs.cameras, self.grid,
                                    inputs.image_hw, self.device,
                                    ref.DTYPES[self.precision["projection"]])
        self._masks = {}

    def frames(self, j) -> torch.Tensor:
        return torch.from_numpy(self.inputs.video[j]).to(self.device)

    def masks(self, j) -> torch.Tensor:
        """(C, H, W) bool cleaned masks of video frame ``j``."""
        if j not in self._masks:
            raw = ref.raw_masks(self.models, self.frames(j), self.mog)
            self._masks[j] = ref.clean_masks(raw, self.mask_params)
        return self._masks[j]

    def outputs(self, j):
        """(occupancy (N,) bool, colours (N, 3) u8) of video frame ``j``."""
        return ref.carve(self.masks(j), self.frames(j), self.proj,
                         self.views_threshold, self.color_camera)


def lower_precision(precision: dict) -> dict:
    """Each stage one floating type below the configuration's: the
    control's precision."""
    return {k: LOWER[v] for k, v in precision.items()}


def compare(kept, reference: Reference) -> dict:
    """The numbers compared, over the kept outputs [(video frame, occ,
    col)]."""
    occ_diff = color_diff = 0
    for j, occ, col in kept:
        r_occ, r_col = reference.outputs(j)
        occ = occ.to(reference.device).reshape(-1)
        col = col.to(reference.device).reshape(-1, 3)
        occ_diff += int((occ != r_occ).sum())
        color_diff += int((col != r_col).any(dim=1).sum())
    return {"occ_diff": occ_diff, "color_diff": color_diff}


def judged(numbers: dict) -> dict:
    """Each number beside its limit, and whether all are within."""
    out = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return out, all(v <= LIMITS[k] for k, v in numbers.items())


def sample(seed: int, count: int, n: int, bursts=()) -> list:
    """``count`` distinct numbers below ``n`` drawn from ``seed``, and one
    more drawn from ``bursts`` where it holds any (the frames whose
    cleanup the program redoes)."""
    rng = np.random.default_rng(int(seed))
    picks = {int(x) for x in rng.choice(n, size=min(count, n),
                                        replace=False)}
    if len(bursts):
        picks.add(int(rng.choice(np.asarray(bursts))))
    return sorted(picks)


def kept_frames(seed: int, traffic: dict, seconds: float) -> list:
    """The frames of a window of ``seconds`` whose outputs are checked
    (numbers of the loop's due frames; frame k shows video frame k mod the
    video's length): ``check_frames`` drawn from the seed, and one burst
    frame where the window holds any."""
    n = spec.loop(traffic["loop"]).due_count(traffic, seconds)
    F = int(traffic["video_frames"])
    bursts = [k for k in range(n) if rigdata.is_burst(traffic, k % F)]
    return sample(seed, int(traffic["check_frames"]), n, bursts)
