"""Host-side video ingest and output: AVI files without OpenCV.

Counterpart of ``vbr_tpu/utils/video.py`` (``_capture``,
``video_properties``, ``read_video``, ``frame_iterator``, ``get_frame``,
``MultiCameraSource``).  Decoding stays on the host, as there: frames come
out as contiguous (H, W, 3) u8 BGR arrays, as ``cv2.VideoCapture`` returns
them, and the models upload them.

The container is parsed here: the RIFF ``hdrl`` list (``avih``, each
stream's ``strh`` / ``strf``), the ``movi`` list and its ``nndc`` / ``nndb``
chunks (odd sizes padded, ``JUNK`` and ``LIST rec`` skipped), the ``idx1``
index where there is one (else ``movi`` is walked), and the ``movi`` lists
of OpenDML's ``RIFF AVIX`` extensions.  Two codecs are read:

  * ``MJPG``: each chunk is a JPEG, decoded by PIL (imported at the first
    such decode); a frame without Huffman tables gets the standard ones of
    ITU-T T.81 Annex K.3, as FFmpeg gives them; a grey JPEG becomes three
    equal channels.  PIL's decoder gives the bits of OpenCV's own MJPEG
    reader (``cv2.CAP_OPENCV_MJPEG``), not those of its FFmpeg backend.
  * uncompressed 24-bit ``BI_RGB``: rows bottom-up (positive height) or
    top-down, each padded to 4 bytes.

Any other FourCC (``FMP4``, ``XVID``, ``H264``, ...) raises ``ValueError``
naming it.  :class:`AviWriter` writes MJPEG (PIL's JPEG encoder) or
``BI_RGB`` AVI files with an ``idx1`` index, which both of OpenCV's
readers open.  ``ArraySource`` serves frames already decoded.
"""

from __future__ import annotations

import io
import math
import os
import struct
from typing import (Iterable, Iterator, List, NamedTuple, Optional, Protocol,
                    Tuple, Union)

import numpy as np

JPEG_QUALITY = 95  # the writer's default, as OpenCV's MJPEG writer's
_AVIIF_KEYFRAME = 0x10


# ---------------------------------------------------------------------------
# The standard Huffman tables (ITU-T T.81 Annex K.3): (class/id, counts of
# codes of lengths 1..16, values).
# ---------------------------------------------------------------------------

_STD_DHT = (
    (0x00, (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12))),
    (0x10, (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), (
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA)),
    (0x01, (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12))),
    (0x11, (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA)),
)


def _std_dht_segment() -> bytes:
    body = b"".join(bytes((tc,) + bits + vals) for tc, bits, vals in _STD_DHT)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


_DHT_SEGMENT = _std_dht_segment()


def with_huffman_tables(jpeg: bytes) -> bytes:
    """``jpeg`` with the standard Huffman tables inserted before its first
    scan (SOS) when no DHT segment precedes it; otherwise unchanged."""
    i = 2  # past SOI
    n = len(jpeg)
    while i + 4 <= n:
        if jpeg[i] != 0xFF:
            return jpeg  # not a marker where one should be: leave it to PIL
        marker = jpeg[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker == 0xC4:
            return jpeg
        if marker == 0xDA:
            return jpeg[:i] + _DHT_SEGMENT + jpeg[i:]
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:  # no length field
            i += 2
            continue
        i += 2 + struct.unpack(">H", jpeg[i + 2:i + 4])[0]
    return jpeg


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------


class AviInfo(NamedTuple):
    """What the reader needs of an AVI file's first video stream."""

    width: int
    height: int
    fourcc: str  # biCompression as text ("MJPG", "FMP4", ...); "BI_RGB" for 0
    handler: str  # strh.fccHandler
    fps: float  # strh.dwRate / strh.dwScale
    total_frames: int  # avih.dwTotalFrames
    length: int  # strh.dwLength, frames in the stream
    bit_count: int
    bottom_up: bool  # BI_RGB rows stored last row first
    chunks: Tuple[Tuple[int, int], ...]  # (file offset of data, size)


def _fourcc_text(raw: bytes) -> str:
    if raw == b"\0\0\0\0":
        return "BI_RGB"
    return raw.decode("latin1").rstrip("\0 ") or repr(raw)


def _chunks(buf: bytes, start: int, end: int):
    """(id, data offset, size) of each chunk in ``buf[start:end]``."""
    off, end = start, min(end, len(buf))
    while off + 8 <= end:
        ckid = buf[off:off + 4]
        size = struct.unpack("<I", buf[off + 4:off + 8])[0]
        yield ckid, off + 8, size
        off += 8 + size + (size & 1)


def _parse_strl(buf: bytes, start: int, end: int):
    strh = strf = None
    for ckid, off, size in _chunks(buf, start, end):
        if ckid == b"strh":
            strh = buf[off:off + size]
        elif ckid == b"strf":
            strf = buf[off:off + size]
    return strh, strf


class _File:
    """Random access to a file by (offset, size) reads."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        self.f.seek(0, os.SEEK_END)
        self.size = self.f.tell()

    def read(self, off: int, size: int) -> bytes:
        self.f.seek(off)
        return self.f.read(size)

    def close(self):
        self.f.close()


def _walk_movi(fh: _File, start: int, end: int, ids) -> List[Tuple[int, int]]:
    """The chunks with an id in ``ids`` between ``start`` and ``end`` of a
    ``movi`` list, descending into ``LIST rec`` lists."""
    out = []
    off = start
    while off + 8 <= end:
        head = fh.read(off, 12)
        if len(head) < 8:
            break
        ckid = head[:4]
        size = struct.unpack("<I", head[4:8])[0]
        if ckid == b"LIST" and head[8:12] == b"rec ":
            out.extend(_walk_movi(fh, off + 12, off + 8 + size, ids))
        elif ckid in ids:
            out.append((off + 8, size))
        off += 8 + size + (size & 1)
    return out


def _from_idx1(fh: _File, idx: bytes, movi_fourcc: int, ids):
    """The index's entries of ``ids`` as (data offset, size); the offsets
    count from the ``movi`` list's FourCC or from the file's start
    (whichever points at a chunk of the entry's id); None when neither
    does."""
    entries = [struct.unpack("<4sIII", idx[i:i + 16])
               for i in range(0, len(idx) - 15, 16)]
    entries = [(off, size) for ckid, _, off, size in entries if ckid in ids]
    if not entries:
        return None
    off0 = entries[0][0]
    for base in (movi_fourcc, 0):
        head = fh.read(base + off0, 4)
        if head in ids:
            return [(base + off + 8, size) for off, size in entries]
    return None


def parse_avi(path: str) -> AviInfo:
    """Read the headers and the frame index of an AVI file's first video
    stream.  A missing file raises ``FileNotFoundError``; a file that is
    not a RIFF AVI or has no video stream, ``ValueError``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot open video: {path}")
    fh = _File(path)
    try:
        return _parse(fh, path)
    finally:
        fh.close()


def _parse(fh: _File, path: str) -> AviInfo:
    head = fh.read(0, 12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file (starts with "
                         f"{head[:12]!r})")
    riff_end = min(8 + struct.unpack("<I", head[4:8])[0], fh.size)
    avih = stream = None
    movi = idx1 = None
    n_strl = 0
    off = 12
    while off + 8 <= riff_end:
        h = fh.read(off, 12)
        ckid, size = h[:4], struct.unpack("<I", h[4:8])[0]
        if ckid == b"LIST" and h[8:12] == b"hdrl":
            hdrl = fh.read(off + 12, max(size - 4, 0))
            for cid, coff, csize in _chunks(hdrl, 0, len(hdrl)):
                if cid == b"avih":
                    avih = hdrl[coff:coff + csize]
                elif cid == b"LIST" and hdrl[coff:coff + 4] == b"strl":
                    strh, strf = _parse_strl(hdrl, coff + 4, coff + csize)
                    if stream is None and strh is not None \
                            and strh[:4] == b"vids":
                        stream = (n_strl, strh, strf)
                    n_strl += 1
        elif ckid == b"LIST" and h[8:12] == b"movi" and movi is None:
            movi = (off + 8, off + 8 + size)  # from its FourCC to its end
        elif ckid == b"idx1":
            idx1 = fh.read(off + 8, size)
        off += 8 + size + (size & 1)
    if avih is None or stream is None:
        raise ValueError(f"{path}: no video stream in the AVI headers")
    if len(avih) < 40 or len(stream[1]) < 36 or stream[2] is None \
            or len(stream[2]) < 20:
        raise ValueError(f"{path}: truncated AVI headers")
    if movi is None:
        raise ValueError(f"{path}: the AVI file has no 'movi' list")
    return _info(fh, path, avih, stream, movi, idx1, riff_end)


def _info(fh, path, avih, stream, movi, idx1, riff_end) -> AviInfo:
    num, strh, strf = stream
    ids = {b"%02ddc" % num, b"%02ddb" % num}
    (_, _, _, _, total_frames, _, _, _, aw, ah) = struct.unpack(
        "<10I", avih[:40])
    (_, handler, _, _, _, _, scale, rate, _, length) = struct.unpack(
        "<4s4sIHHIIIII", strh[:36])
    _, bw, bh, _, bits, comp = struct.unpack("<IiiHH4s", strf[:20])
    chunks = _from_idx1(fh, idx1, movi[0], ids) if idx1 else None
    if chunks is None:
        chunks = _walk_movi(fh, movi[0] + 4, movi[1], ids)
    # OpenDML: further RIFF 'AVIX' lists, each with a movi list of its own
    off = riff_end + (riff_end & 1)
    while off + 12 <= fh.size:
        h = fh.read(off, 12)
        size = struct.unpack("<I", h[4:8])[0]
        if h[:4] == b"RIFF" and h[8:12] == b"AVIX":
            end = min(off + 8 + size, fh.size)
            for ckid, coff, csize in _top_chunks(fh, off + 12, end):
                if ckid == b"LIST" and fh.read(coff, 4) == b"movi":
                    chunks += _walk_movi(fh, coff + 4, coff + csize, ids)
        off += 8 + size + (size & 1)
    return AviInfo(
        width=abs(bw) or aw, height=abs(bh) or ah, fourcc=_fourcc_text(comp),
        handler=_fourcc_text(handler),
        fps=rate / scale if scale else 0.0, total_frames=total_frames,
        length=length, bit_count=bits, bottom_up=bh > 0,
        chunks=tuple(chunks))


def _top_chunks(fh: _File, start: int, end: int):
    off = start
    while off + 8 <= end:
        h = fh.read(off, 8)
        size = struct.unpack("<I", h[4:8])[0]
        yield h[:4], off + 8, size
        off += 8 + size + (size & 1)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _codec(info: AviInfo, path: str) -> str:
    if info.fourcc.upper() == "MJPG":
        return "mjpeg"
    if info.fourcc == "BI_RGB" and info.bit_count == 24:
        return "bi_rgb"
    name = info.fourcc if info.fourcc != "BI_RGB" else \
        f"BI_RGB {info.bit_count}-bit"
    raise ValueError(
        f"{path}: video codec {name!r} (handler {info.handler!r}) is not "
        "supported: the port decodes MJPEG and uncompressed 24-bit BI_RGB "
        "AVI files only")


def decode_jpeg(data: bytes) -> np.ndarray:
    """One JPEG → (H, W, 3) u8 BGR through PIL (grey: 3 equal channels)."""
    from PIL import Image

    with Image.open(io.BytesIO(with_huffman_tables(data))) as im:
        im.load()
        if im.mode == "L":
            g = np.asarray(im)
            return np.repeat(g[..., None], 3, axis=-1)
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.ascontiguousarray(np.asarray(im)[..., ::-1])


def _decode_bi_rgb(data: bytes, info: AviInfo) -> np.ndarray:
    W, H = info.width, info.height
    stride = (W * 3 + 3) // 4 * 4
    if len(data) < stride * H:
        raise ValueError(f"BI_RGB frame of {len(data)} bytes, want "
                         f"{stride * H} for {W}x{H}")
    rows = np.frombuffer(data, np.uint8, stride * H).reshape(H, stride)
    img = rows[:, :W * 3].reshape(H, W, 3)
    return np.ascontiguousarray(img[::-1] if info.bottom_up else img)


class AviReader:
    """Sequential frames of an AVI file, with ``cv2.VideoCapture``'s
    ``read()`` → (ok, frame) and ``release()``; also iterable."""

    def __init__(self, path: str):
        self.path = path
        self.info = parse_avi(path)
        self._codec = _codec(self.info, path)
        self._fh = _File(path)
        self._next = 0

    @property
    def width(self) -> int:
        return self.info.width

    @property
    def height(self) -> int:
        return self.info.height

    @property
    def frame_count(self) -> int:
        """The container's count: ``strh.dwLength`` (``avih``'s total where
        that is 0)."""
        return self.info.length or self.info.total_frames

    def read_raw(self) -> Optional[bytes]:
        """The next frame's chunk as stored, or None at the end; empty
        chunks (dropped frames) are skipped."""
        while self._fh is not None and self._next < len(self.info.chunks):
            off, size = self.info.chunks[self._next]
            self._next += 1
            if size:
                return self._fh.read(off, size)
        return None

    def decode(self, data: bytes) -> np.ndarray:
        if self._codec == "mjpeg":
            return decode_jpeg(data)
        return _decode_bi_rgb(data, self.info)

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        data = self.read_raw()
        if data is None:
            return False, None
        return True, self.decode(data)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.read()
            if not ok:
                return
            yield frame

    def release(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _capture(path: str) -> AviReader:
    """An open reader of ``path``; ``FileNotFoundError`` when it cannot be
    opened, ``ValueError`` for a codec the port does not decode."""
    return AviReader(path)


def video_properties(path: str, accurate: bool = False) -> Tuple[int, int, int]:
    """(width, height, frame_count).  ``accurate`` decodes every frame to
    count them; otherwise the container's count."""
    with _capture(path) as cap:
        if accurate:
            n = sum(1 for _ in cap)
        else:
            n = cap.frame_count
        return cap.width, cap.height, n


def read_video(path: str, max_frames: Optional[int] = None,
               step: int = 1) -> np.ndarray:
    """Decode a video into a (T, H, W, 3) u8 BGR batch: every ``step``-th
    frame, at most ``max_frames`` of them."""
    frames = []
    with _capture(path) as cap:
        i = 0
        while True:
            data = cap.read_raw()
            if data is None:
                break
            if i % step == 0:
                frames.append(cap.decode(data))
            i += 1
            if max_frames is not None and len(frames) >= max_frames:
                break
    return np.stack(frames)


def frame_iterator(path: str) -> Iterator[np.ndarray]:
    """Stream frames one by one."""
    with _capture(path) as cap:
        yield from cap


def get_frame(path: str, index: int) -> Optional[np.ndarray]:
    """Frame ``index`` (counted as decoding counts them), or None past the
    end."""
    with _capture(path) as cap:
        for _ in range(index):
            if cap.read_raw() is None:
                return None
        ok, frame = cap.read()
        return frame if ok else None


class FrameSource(Protocol):
    def next_frames(self) -> Optional[np.ndarray]:
        """(C, H, W, 3) u8 BGR frames of all cameras, or None at the end."""


class MultiCameraSource:
    """Synchronized per-camera ``cam{i}/<filename>`` streams of a rig."""

    def __init__(self, data_dir: str, num_cameras: int = 4,
                 filename: str = "video.avi"):
        self.caps: List[AviReader] = []
        try:
            for i in range(1, num_cameras + 1):
                self.caps.append(_capture(
                    os.path.join(data_dir, f"cam{i}", filename)))
        except BaseException:
            self.release()
            raise

    def next_frames(self) -> Optional[np.ndarray]:
        """(C, H, W, 3) u8 batch, or None at the end of any camera's
        stream."""
        frames = []
        for cap in self.caps:
            ok, frame = cap.read()
            if not ok:
                return None
            frames.append(frame)
        return np.stack(frames)

    def release(self):
        for cap in self.caps:
            cap.release()


class ArraySource:
    """A frame source over an (F, C, H, W, 3) u8 array or any iterable of
    (C, H, W, 3) u8 arrays, taken in order."""

    def __init__(self, frames: Union[np.ndarray, Iterable[np.ndarray]]):
        self._it: Iterator = iter(frames)

    def next_frames(self) -> Optional[np.ndarray]:
        frames = next(self._it, None)
        return None if frames is None else np.asarray(frames, np.uint8)


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------


def encode_jpeg(frame: np.ndarray) -> bytes:
    """(H, W, 3) u8 BGR → JPEG bytes through PIL's encoder at
    ``JPEG_QUALITY`` (baseline, the standard Huffman tables)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame[..., ::-1])).save(
        buf, "JPEG", quality=JPEG_QUALITY)
    return buf.getvalue()


def write_jpeg(path: str, frame: np.ndarray) -> None:
    """Write an (H, W, 3) u8 BGR image as a JPEG file (``encode_jpeg``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(frame))


def _fps_ratio(fps: float) -> Tuple[int, int]:
    """(dwRate, dwScale) with rate / scale = ``fps`` to 1e-6."""
    scale = 1_000_000
    rate = int(round(fps * scale))
    g = math.gcd(rate, scale) or 1
    return rate // g, scale // g


class AviWriter:
    """An MJPEG AVI file of (H, W, 3) u8 BGR frames (``encode_jpeg``), with
    an ``idx1`` index.  The headers are written at ``close``.

    ``fourcc="BI_RGB"`` writes uncompressed 24-bit rows instead (top-down,
    4-byte stride): the tests' way to make a lossless file for the reader;
    the port itself always writes MJPEG."""

    _HDR = 4096  # bytes held for the headers ahead of the movi list

    def __init__(self, path: str, fps: float, width: int, height: int,
                 fourcc: str = "MJPG"):
        if fourcc not in ("MJPG", "BI_RGB"):
            raise ValueError(f"the writer encodes MJPG or BI_RGB, not "
                             f"{fourcc!r}")
        if width <= 0 or height <= 0 or fps <= 0:
            raise ValueError(f"bad writer geometry {width}x{height} at "
                             f"{fps} fps")
        self.path, self.fps = path, float(fps)
        self.width, self.height = int(width), int(height)
        self.fourcc = fourcc
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(b"\0" * self._HDR)
        self._f.write(b"LIST\0\0\0\0movi")
        self._index: List[Tuple[int, int]] = []  # (offset from 'movi', size)
        self._max = 0

    def write(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame {frame.shape} != writer "
                             f"({self.height}, {self.width}, 3)")
        if self.fourcc == "MJPG":
            ckid, data = b"00dc", encode_jpeg(frame)
        else:
            stride = (self.width * 3 + 3) // 4 * 4
            rows = np.zeros((self.height, stride), np.uint8)
            rows[:, :self.width * 3] = frame.reshape(self.height, -1)
            ckid, data = b"00db", rows.tobytes()
        pos = self._f.tell()
        self._f.write(ckid + struct.pack("<I", len(data)) + data)
        if len(data) & 1:
            self._f.write(b"\0")
        self._index.append((pos - (self._HDR + 8), len(data)))
        self._max = max(self._max, len(data))

    def close(self):
        if self._f is None:
            return
        f, self._f = self._f, None
        try:
            movi_end = f.tell()
            ckid = b"00dc" if self.fourcc == "MJPG" else b"00db"
            idx = b"".join(struct.pack("<4sIII", ckid, _AVIIF_KEYFRAME, off,
                                       size) for off, size in self._index)
            f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
            end = f.tell()
            f.seek(self._HDR + 4)
            f.write(struct.pack("<I", movi_end - (self._HDR + 8)))
            f.seek(0)
            f.write(self._headers(end))
        finally:
            f.close()

    def _headers(self, file_end: int) -> bytes:
        n, W, H = len(self._index), self.width, self.height
        rate, scale = _fps_ratio(self.fps)
        comp = b"MJPG" if self.fourcc == "MJPG" else b"\0\0\0\0"
        handler = b"MJPG" if self.fourcc == "MJPG" else b"\0\0\0\0"
        image_size = ((W * 3 + 3) // 4 * 4) * H
        avih = struct.pack(
            "<10I4I", int(round(1e6 / self.fps)),
            int(self._max * self.fps), 0, 0x10 | 0x100 | 0x800, n, 0, 1,
            self._max, W, H, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4sIHHIIIIIIiI4h", b"vids", handler, 0, 0, 0, 0, scale, rate,
            0, n, self._max, -1, 0, 0, 0, W, H)
        # BI_RGB rows top-down (a negative height): OpenCV's FFmpeg reader
        # fails on bottom-up rows
        strf_h = H if self.fourcc == "MJPG" else -H
        strf = struct.pack("<IiiHH4sIiiII", 40, W, strf_h, 1, 24, comp,
                           image_size, 0, 0, 0, 0)

        def chunk(ckid, body):
            return ckid + struct.pack("<I", len(body)) + body

        strl = b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8
                                     + len(strf)) + b"strl" \
            + chunk(b"strh", strh) + chunk(b"strf", strf)
        hdrl_body = b"hdrl" + chunk(b"avih", avih) + strl
        hdrl = b"LIST" + struct.pack("<I", len(hdrl_body)) + hdrl_body
        head = b"RIFF" + struct.pack("<I", file_end - 8) + b"AVI " + hdrl
        pad = self._HDR - len(head) - 8
        return head + chunk(b"JUNK", b"\0" * pad)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
