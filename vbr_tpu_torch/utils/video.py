"""Frame sources for the viewer seam.

Counterpart of the frame-source protocol of ``vbr_tpu/utils/video.py``
(``MultiCameraSource.next_frames``): ``next_frames()`` returns one frame of
every camera, (C, H, W, 3) u8 BGR, or ``None`` at the end of the stream.
The JAX package decodes the rig's videos with OpenCV; the port has no
decoder yet, so its one source holds frames already decoded.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Protocol, Union

import numpy as np


class FrameSource(Protocol):
    def next_frames(self) -> Optional[np.ndarray]:
        """(C, H, W, 3) u8 BGR frames of all cameras, or None at the end."""


class ArraySource:
    """A frame source over an (F, C, H, W, 3) u8 array or any iterable of
    (C, H, W, 3) u8 arrays, taken in order."""

    def __init__(self, frames: Union[np.ndarray, Iterable[np.ndarray]]):
        self._it: Iterator = iter(frames)

    def next_frames(self) -> Optional[np.ndarray]:
        frames = next(self._it, None)
        return None if frames is None else np.asarray(frames, np.uint8)
