"""K2's share of its roofline (%): the least time one launch on the
frame's C masks needs (``roofline.k2_bytes``) over the mean traced time of
the ``ccl_`` kernels (kernel K2, once per frame)."""

import numpy as np

from benchmark import roofline


def read(run):
    t = run.trace.kernel_times("ccl_") if run.trace else []
    if not t:
        return None
    C = len(run.inputs.cameras)
    least = roofline.least_s(roofline.k2_bytes(C, run.inputs.image_hw), 0)
    return 100.0 * least / float(np.mean(t))
