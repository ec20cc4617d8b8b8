"""Non-blocking warning/failure reporting.

The port's own copy of ``vbr_tpu/utils/warnings_.py``: the reference's
modal tkinter dialogs keyed by message id (``show_warning``, utils.py:7-59)
become structured logging on the same ``"vbr_tpu"`` logger, so one logging
configuration serves both packages.  The message-id table is preserved so
call sites read the same.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("vbr_tpu")

_MESSAGES = {
    "video_none": "Video could not be opened.",
    "frame_none": "Requested frame could not be decoded.",
    "corners_none": "Chessboard corners could not be detected; "
                    "falling back to manual selection.",
    "calibration_failed": "Camera calibration did not converge.",
    "config_missing": "Camera config.xml not found.",
    "board_quad_none": "Board outline could not be estimated.",
    "preview_unavailable": "Interactive preview window unavailable on "
                           "this host; previews disabled.",
    "preview_failed": "Interactive preview failed for this image; "
                      "later previews are unaffected.",
}


def show_warning(message_id: str, detail: str = "") -> str:
    """Log a keyed warning (returns the resolved message for testing)."""
    msg = _MESSAGES.get(message_id, f"unknown warning: {message_id}")
    if detail:
        msg = f"{msg} ({detail})"
    logger.warning(msg)
    return msg
