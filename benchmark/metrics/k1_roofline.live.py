"""K1's share of its roofline (%): the least time one frame's carve needs
(``roofline.k1_work`` from the reference's masks and projections, the
mean over the checked frames) over the mean traced time of the
``carve_blocked`` kernels (kernel K1, once per frame)."""

import numpy as np

from benchmark import roofline


def read(run):
    t = run.trace.kernel_times("carve_blocked") if run.trace else []
    if not t:
        return None
    r = run.reference
    blocks = roofline.Blocks(r.grid, r.device)
    least = []
    for j in sorted({j for j, _, _ in run.kept}):
        occ, _ = r.outputs(j)
        least.append(roofline.least_s(*roofline.k1_work(
            r.proj, blocks, r.masks(j), occ, r.views_threshold,
            r.color_camera)))
    return 100.0 * float(np.mean(least)) / float(np.mean(t))
