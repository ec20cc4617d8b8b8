"""Timed result previews (the ``--preview MS`` option of the CLI).

Counterpart of ``vbr_tpu/utils/preview.py``, whose ``show_result`` shows an
image in an OpenCV window for ``ms`` milliseconds (the reference's
``result_time_visible``; ``ms <= 0`` disables it) and, on a host without a
display, warns once and then does nothing.  The port has no window
toolkit, so it always behaves as on such a host.
"""

from __future__ import annotations

import numpy as np

from vbr_tpu_torch.utils import warnings_

_DISABLED = False


def show_result(window: str, image: np.ndarray, ms: int) -> bool:
    """Would show ``image`` for ``ms`` milliseconds: the first call with
    ``ms > 0`` logs ``preview_unavailable``, and every call returns False
    (no window was shown)."""
    global _DISABLED
    if ms <= 0 or _DISABLED:
        return False
    _DISABLED = True
    warnings_.show_warning(
        "preview_unavailable",
        f"interactive preview disabled (no window toolkit; {window!r})")
    return False


def close_all() -> None:
    """Destroy any preview windows (there are none)."""
