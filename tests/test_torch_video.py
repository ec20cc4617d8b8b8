"""``vbr_tpu_torch/utils/video.py`` and the native video threads against
OpenCV: every reader form gives the frames of
``cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)`` bit for bit on MJPEG AVI
files from both of OpenCV's writers and from the port's own, with the same
frame counts; the uncompressed (``BI_RGB``) files round-trip exactly;
other codecs raise naming their FourCC; frames without Huffman tables
decode; ``PrefetchingSource`` gives ``MultiCameraSource``'s frames and
hands a decoding error to its caller."""

import os
import struct

import cv2
import numpy as np
import pytest

from vbr_tpu.utils import video as jvio
from vbr_tpu_torch import native
from vbr_tpu_torch.utils import video as vio

H, W, T = 120, 160, 6
WRITERS = ("ffmpeg", "opencv_mjpeg", "port")


def _frames(seed=0, n=T, hw=(H, W)):
    """Smooth colour ramps with a moving square and noise: JPEG's
    chroma subsampling and quantisation both matter."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    out = []
    for t in range(n):
        img = np.stack([(xx * 255 // w), (yy * 255 // h),
                        np.full_like(xx, 40 * t % 256)], -1).astype(np.int32)
        img[10 + 5 * t:40 + 5 * t, 20 + 7 * t:60 + 7 * t] = (30, 200, 90)
        img += rng.integers(-12, 13, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _write(path, frames, writer, fps=10.0):
    h, w = frames[0].shape[:2]
    if writer == "port":
        with native.VideoSink(str(path), fps, w, h) as sink:
            for f in frames:
                sink.write(f)
        return str(path)
    api = {"ffmpeg": cv2.CAP_FFMPEG,
           "opencv_mjpeg": cv2.CAP_OPENCV_MJPEG}[writer]
    out = cv2.VideoWriter(str(path), api, cv2.VideoWriter_fourcc(*"MJPG"),
                          fps, (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(f)
    out.release()
    return str(path)


def _opencv_frames(path, api=cv2.CAP_OPENCV_MJPEG):
    cap = cv2.VideoCapture(path, api)
    assert cap.isOpened()
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return frames, n


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """One rig directory per writer: cam1 and cam2 ``video.avi``."""
    root = tmp_path_factory.mktemp("videos")
    out = {}
    for writer in WRITERS:
        d = root / writer
        for cam in (1, 2):
            (d / f"cam{cam}").mkdir(parents=True)
            _write(d / f"cam{cam}" / "video.avi", _frames(cam), writer)
        out[writer] = str(d)
    return out


def _path(videos, writer, cam=1):
    return os.path.join(videos[writer], f"cam{cam}", "video.avi")


@pytest.mark.parametrize("writer", WRITERS)
def test_every_reader_form_equals_opencv_mjpeg(videos, writer):
    path = _path(videos, writer)
    want, _ = _opencv_frames(path)
    assert len(want) == T
    # JPEG is lossy: the reference decode is not the input
    assert any(not np.array_equal(a, b) for a, b in zip(want, _frames(1)))
    got = vio.read_video(path)
    assert got.shape == (T, H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.stack(want))
    for a, b in zip(vio.frame_iterator(path), want):
        np.testing.assert_array_equal(a, b)
    for i in (0, 3, T - 1):
        np.testing.assert_array_equal(vio.get_frame(path, i), want[i])
    np.testing.assert_array_equal(vio.read_video(path, max_frames=2, step=2),
                                  np.stack(want[0:4:2]))
    with vio._capture(path) as cap:
        ok, f = cap.read()
        assert ok
        np.testing.assert_array_equal(f, want[0])


@pytest.mark.parametrize("writer", WRITERS)
def test_frame_counts_agree(videos, writer):
    """The container's count (``accurate=False``) equals OpenCV's
    ``CAP_PROP_FRAME_COUNT`` and the decoded count."""
    path = _path(videos, writer)
    _, n_cv = _opencv_frames(path)
    assert vio.video_properties(path) == (W, H, n_cv) == (W, H, T)
    assert vio.video_properties(path, accurate=True) == (W, H, T)
    info = vio.parse_avi(path)
    assert info.fourcc == "MJPG" and info.length == info.total_frames == T
    assert info.fps == pytest.approx(10.0)


@pytest.mark.parametrize("writer", WRITERS)
def test_get_frame_past_the_end_is_none(videos, writer):
    assert vio.get_frame(_path(videos, writer), T) is None
    assert vio.get_frame(_path(videos, writer), T + 5) is None


@pytest.mark.parametrize("writer", WRITERS)
def test_sources_equal_the_reference_decode(videos, writer):
    """``MultiCameraSource`` and ``PrefetchingSource`` give the same
    (C, H, W, 3) batches, then None; ``vbr_tpu``'s ``read_video`` and
    ``MultiCameraSource`` through OpenCV's MJPEG reader give the same
    frames as the port's."""
    want = [np.stack(fs) for fs in zip(
        *[_opencv_frames(_path(videos, writer, c))[0] for c in (1, 2)])]
    src = vio.MultiCameraSource(videos[writer], num_cameras=2)
    pre = native.PrefetchingSource(
        [_path(videos, writer, c) for c in (1, 2)], queue_capacity=2)
    assert (pre.num_cameras, pre.height, pre.width) == (2, H, W)
    for w in want:
        np.testing.assert_array_equal(src.next_frames(), w)
        np.testing.assert_array_equal(pre.next_frames(), w)
    assert src.next_frames() is None and pre.next_frames() is None
    assert pre.next_frames() is None
    src.release()
    pre.close()

    orig = cv2.VideoCapture
    cv2.VideoCapture = lambda p, *a: orig(p, cv2.CAP_OPENCV_MJPEG)
    try:
        np.testing.assert_array_equal(
            jvio.read_video(_path(videos, writer), step=2),
            vio.read_video(_path(videos, writer), step=2))
        jsrc = jvio.MultiCameraSource(videos[writer], num_cameras=2)
        np.testing.assert_array_equal(jsrc.next_frames(), want[0])
        jsrc.release()
    finally:
        cv2.VideoCapture = orig


def test_the_ports_writer_is_read_by_opencvs_ffmpeg_backend(videos):
    """OpenCV's default (FFmpeg) reader opens the port's file with the same
    count and size; its decoder upsamples chroma in its own way, so its
    pixels differ by a few levels."""
    path = _path(videos, "port")
    frames, n = _opencv_frames(path, cv2.CAP_FFMPEG)
    assert n == T and len(frames) == T
    ours = vio.read_video(path)
    for a, b in zip(frames, ours):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b).mean() < 4.0


@pytest.mark.parametrize("bottom_up", [False, True])
def test_bi_rgb_round_trips_exactly(tmp_path, bottom_up):
    """Uncompressed 24-bit frames with a row stride padded to 4 bytes (a
    width of 37 pixels): written top-down, read back exactly; the same
    file turned bottom-up (positive height, rows reversed) too."""
    frames = _frames(3, n=3, hw=(21, 37))
    path = str(tmp_path / "raw.avi")
    with vio.AviWriter(path, 25.0, 37, 21, fourcc="BI_RGB") as w:
        for f in frames:
            w.write(f)
    if bottom_up:
        info = vio.parse_avi(path)
        buf = bytearray(open(path, "rb").read())
        strf = buf.index(b"strf") + 8
        buf[strf + 8:strf + 12] = struct.pack("<i", 21)
        stride = (37 * 3 + 3) // 4 * 4
        for off, size in info.chunks:
            rows = np.frombuffer(bytes(buf[off:off + size]), np.uint8)
            buf[off:off + size] = rows.reshape(21, stride)[::-1].tobytes()
        open(path, "wb").write(bytes(buf))
    info = vio.parse_avi(path)
    assert info.fourcc == "BI_RGB" and info.bottom_up == bottom_up
    np.testing.assert_array_equal(vio.read_video(path), np.stack(frames))
    if not bottom_up:  # OpenCV's FFmpeg reader: the same pixels
        got, n = _opencv_frames(path, cv2.CAP_FFMPEG)
        assert n == 3
        np.testing.assert_array_equal(np.stack(got), np.stack(frames))


def test_other_codecs_raise_naming_their_fourcc(tmp_path):
    from vbr_tpu import native as jnative

    path = str(tmp_path / "mp4v.avi")
    sink = jnative.VideoSink(path, 10.0, 64, 48)
    for _ in range(2):
        sink.write(np.zeros((48, 64, 3), np.uint8))
    sink.close()
    for call in (vio.read_video, vio.frame_iterator, vio.video_properties,
                 lambda p: vio.get_frame(p, 0), vio._capture,
                 lambda p: native.PrefetchingSource([p])):
        with pytest.raises(ValueError, match="codec 'mp4v'"):
            out = call(path)
            list(out) if hasattr(out, "__next__") else out
    mp4 = str(tmp_path / "clip.mp4")
    sink = jnative.VideoSink(mp4, 10.0, 64, 48)
    sink.write(np.zeros((48, 64, 3), np.uint8))
    sink.close()
    with pytest.raises(ValueError, match="not a RIFF AVI"):
        vio.read_video(mp4)


def test_a_missing_file_raises(tmp_path):
    missing = str(tmp_path / "none.avi")
    for call in (vio.read_video, vio._capture, vio.video_properties,
                 lambda p: native.PrefetchingSource([p])):
        with pytest.raises(FileNotFoundError, match="cannot open video"):
            call(missing)
    with pytest.raises(FileNotFoundError):
        vio.MultiCameraSource(str(tmp_path), num_cameras=1)


def _segments(jpeg):
    """(marker, start, end) of each segment before the scan."""
    out, i = [], 2
    while jpeg[i + 1] != 0xDA:
        n = struct.unpack(">H", jpeg[i + 2:i + 4])[0]
        out.append((jpeg[i + 1], i, i + 2 + n))
        i += 2 + n
    return out


def test_the_standard_huffman_tables_are_the_encoders():
    """PIL's baseline encoder emits the tables of T.81 Annex K.3: the
    segment the reader inserts holds the same four tables."""
    jpeg = vio.encode_jpeg(_frames()[0])
    tables = b"".join(jpeg[s + 4:e] for m, s, e in _segments(jpeg)
                      if m == 0xC4)
    assert tables == vio._DHT_SEGMENT[4:]


@pytest.mark.parametrize("writer", ["opencv_mjpeg", "port"])
def test_frames_without_huffman_tables_decode(tmp_path, videos, writer):
    """An MJPEG stream whose frames carry no DHT segment: each decodes
    as the full frame does, through ``decode_jpeg`` and through the
    reader (the AVI rewritten with stripped frames and no index).  Both
    writers encode with the standard tables (FFmpeg's writer computes
    optimal ones per frame, which a frame cannot leave out)."""
    path = _path(videos, writer)
    info = vio.parse_avi(path)
    raw = open(path, "rb").read()
    stripped = []
    for off, size in info.chunks:
        jpeg = raw[off:off + size]
        segs = [(s, e) for m, s, e in _segments(jpeg) if m == 0xC4]
        assert segs
        cut = jpeg
        for s, e in reversed(segs):
            cut = cut[:s] + cut[e:]
        assert b"\xff\xc4" not in cut[:_segments(jpeg)[-1][2]]
        np.testing.assert_array_equal(vio.decode_jpeg(cut),
                                      vio.decode_jpeg(jpeg))
        stripped.append(cut)
    out = str(tmp_path / "stripped.avi")
    _write_chunks(out, stripped, index=False)
    np.testing.assert_array_equal(vio.read_video(out), vio.read_video(path))


def _write_chunks(path, payloads, index=True, junk=True, rec=False,
                  avix=()):
    """A minimal MJPEG AVI around ``payloads``: odd sizes padded, a
    ``JUNK`` chunk and (``rec``) a ``LIST rec`` inside ``movi``, ``idx1``
    when ``index``; ``avix``: payloads of an OpenDML ``RIFF AVIX``."""
    def chunk(ckid, body):
        return ckid + struct.pack("<I", len(body)) + body + \
            (b"\0" if len(body) & 1 else b"")

    def lst(kind, body):
        return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body

    n = len(payloads)
    avih = struct.pack("<10I4I", 100000, 0, 0, 0x10, n, 0, 1, 0, W, H,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"MJPG", 0, 0, 0, 0,
                       1, 10, 0, n + sum(map(len, avix)), 0, -1, 0, 0, 0, W,
                       H)
    strf = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG",
                       W * H * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi_items = chunk(b"JUNK", b"\0" * 7) if junk else b""
    offsets = []
    for i, p in enumerate(payloads):
        c = chunk(b"00dc", p)
        if rec and i == 1:
            c = lst(b"rec ", c)
            offsets.append((4 + len(movi_items) + 12, len(p)))
        else:
            offsets.append((4 + len(movi_items), len(p)))
        movi_items += c
    body = hdrl + lst(b"movi", movi_items)
    if index:
        body += chunk(b"idx1", b"".join(
            struct.pack("<4sIII", b"00dc", 0x10, o, s) for o, s in offsets))
    data = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body
    for group in avix:
        items = b"".join(chunk(b"00dc", p) for p in group)
        ext = lst(b"movi", items)
        data += b"RIFF" + struct.pack("<I", 4 + len(ext)) + b"AVIX" + ext
    open(path, "wb").write(data)


@pytest.mark.parametrize("index", [True, False])
@pytest.mark.parametrize("rec", [False, True])
def test_container_layouts(tmp_path, index, rec):
    """The index or the walk, ``JUNK``, odd payload sizes, a ``LIST rec``
    and OpenDML's ``RIFF AVIX`` extension all give the frames in order."""
    frames = _frames(5, n=5)
    payloads = [vio.encode_jpeg(f) for f in frames]
    payloads = [p + b"\0" if len(p) % 2 == 0 else p for p in payloads]
    assert all(len(p) % 2 == 1 for p in payloads)
    path = str(tmp_path / "layout.avi")
    _write_chunks(path, payloads[:3], index=index, rec=rec,
                  avix=[payloads[3:]])
    want = [vio.decode_jpeg(p) for p in payloads]
    got = vio.read_video(path)
    assert len(got) == 5
    np.testing.assert_array_equal(got, np.stack(want))
    assert vio.video_properties(path) == (W, H, 5)


def test_a_grey_jpeg_gives_three_equal_channels(tmp_path):
    from PIL import Image
    import io

    g = _frames()[0][..., 1]
    buf = io.BytesIO()
    Image.fromarray(g).save(buf, "JPEG", quality=90)
    path = str(tmp_path / "grey.avi")
    _write_chunks(path, [buf.getvalue()])
    got = vio.read_video(path)[0]
    assert (got[..., 0] == got[..., 1]).all() and \
        (got[..., 1] == got[..., 2]).all()
    want = cv2.imdecode(np.frombuffer(buf.getvalue(), np.uint8),
                        cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want)
    ref, _ = _opencv_frames(path)
    np.testing.assert_array_equal(got, ref[0])


def test_prefetching_source_raises_a_decoding_error(tmp_path):
    """A frame that is not a JPEG: the decoding thread's error is raised
    by ``next_frames`` (after the good frames), not swallowed."""
    frames = _frames(7, n=4)
    payloads = [vio.encode_jpeg(f) for f in frames]
    payloads[2] = b"\xff\xd8" + b"\x00" * 64
    bad, good = str(tmp_path / "bad.avi"), str(tmp_path / "good.avi")
    _write_chunks(bad, payloads)
    _write_chunks(good, [vio.encode_jpeg(f) for f in frames])
    src = native.PrefetchingSource([good, bad], queue_capacity=1)
    for i in range(2):
        got = src.next_frames()
        assert got.shape == (2, H, W, 3)
        np.testing.assert_array_equal(got[1], vio.decode_jpeg(payloads[i]))
    with pytest.raises(OSError):
        src.next_frames()
    assert src.next_frames() is None
    src.close()


def test_prefetching_source_closes_early(videos):
    """``close`` before the end stops the threads (their queues full)."""
    src = native.PrefetchingSource([_path(videos, "port", c)
                                    for c in (1, 2)], queue_capacity=1)
    assert src.next_frames() is not None
    src.close()
    assert all(not t.is_alive() for t in src._threads)
    assert src.next_frames() is None


def test_video_sink_checks_the_frame_size(tmp_path):
    with native.VideoSink(str(tmp_path / "s.avi"), 5.0, 32, 16) as sink:
        with pytest.raises(ValueError, match=r"writer \(16, 32, 3\)"):
            sink.write(np.zeros((17, 32, 3), np.uint8))
        sink.write(np.zeros((16, 32, 3), np.uint8))
    assert vio.video_properties(str(tmp_path / "s.avi")) == (32, 16, 1)
    with pytest.raises(ValueError, match="MJPG or BI_RGB"):
        vio.AviWriter(str(tmp_path / "x.avi"), 5.0, 32, 16, fourcc="XVID")


def test_write_jpeg_matches_the_encoder(tmp_path):
    f = _frames()[0]
    path = str(tmp_path / "a" / "f.jpg")
    vio.write_jpeg(path, f)
    assert open(path, "rb").read() == vio.encode_jpeg(f)
    np.testing.assert_array_equal(cv2.imread(path), vio.decode_jpeg(
        vio.encode_jpeg(f)))


def test_truncated_or_foreign_files_raise(tmp_path, videos):
    """A file cut inside its headers, or with no video stream, raises
    ``ValueError``; a file cut inside ``movi`` gives the frames it holds
    whole (the index points past its end, so the list is walked)."""
    data = open(_path(videos, "port"), "rb").read()
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:100])
    with pytest.raises(ValueError):
        vio.read_video(str(cut))
    info = vio.parse_avi(_path(videos, "port"))
    off, size = info.chunks[2]
    cut.write_bytes(data[:off + size])
    got = vio.read_video(str(cut))
    np.testing.assert_array_equal(got, vio.read_video(_path(videos, "port"))[:3])
    audio = tmp_path / "audio.avi"
    audio.write_bytes(data.replace(b"vids", b"auds"))
    with pytest.raises(ValueError, match="no video stream"):
        vio.read_video(str(audio))
