"""K4's share of its roofline (%): the least time one chunk's carve needs
(``roofline.k4_work`` from the reference's masks and projections, the
mean over the chunks that hold the checked frames) over the mean traced
time of the ``carve_frames`` kernels (kernel K4, once per chunk)."""

import numpy as np
import torch

from benchmark import roofline


def read(run):
    t = run.trace.kernel_times("carve_frames") if run.trace else []
    if not t:
        return None
    r = run.reference
    nf = int(run.traffic["frames_per_launch"])
    last = len(run.inputs.video) - 1
    blocks = roofline.Blocks(r.grid, r.device)
    least = []
    for s in sorted({j // nf * nf for j, _, _ in run.kept}):
        # the last chunk is padded with the video's last frame
        chunk = torch.stack([r.masks(min(s + i, last)) for i in range(nf)])
        least.append(roofline.least_s(*roofline.k4_work(
            r.proj, blocks, chunk, r.views_threshold)))
    return 100.0 * float(np.mean(least)) / float(np.mean(t))
