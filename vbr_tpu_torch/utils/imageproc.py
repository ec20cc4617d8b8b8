"""Host-side image set utilities.

The port's own copy of ``vbr_tpu/utils/imageproc.py``.
``uniform_image_dimensions`` mirrors the reference's crop-to-common-dims
helper (utils.py:62-112): image sets fed to calibration must share a
shape; larger images are center-cropped to the minimum dimensions.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def uniform_image_dimensions(
    images: Sequence[np.ndarray],
) -> Tuple[List[np.ndarray], Tuple[int, int]]:
    """Center-crop a set of images to their common minimum (H, W).

    Returns (cropped images, (H_min, W_min)).
    """
    if not images:
        return [], (0, 0)
    h_min = min(img.shape[0] for img in images)
    w_min = min(img.shape[1] for img in images)
    out = []
    for img in images:
        h, w = img.shape[:2]
        y0 = (h - h_min) // 2
        x0 = (w - w_min) // 2
        out.append(img[y0 : y0 + h_min, x0 : x0 + w_min])
    return out, (h_min, w_min)
