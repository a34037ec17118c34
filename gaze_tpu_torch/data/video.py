"""Video -> frame extraction: the host step before the GTEA layout.

The port's own copy of ``gaze_tpu/data/video.py`` (standard library
only). The paper's workflow turns each recording into
``images/<video>/*.jpg`` with ffmpeg before anything else runs; the card
has no part in it. ``extract_frames`` tries three routes in order:

- ``ffmpeg`` on PATH (any codec);
- a pure-Python MJPEG-AVI demuxer (``extract_frames_mjpeg_avi``): an
  MJPEG AVI stores each frame as a complete JPEG inside RIFF ``00dc``
  chunks, so the JPEG payloads are copied to disk as they are and the
  JPEG decoder (``data/native_io.py``) takes it from there;
- OpenCV's ``VideoCapture`` (``extract_frames_cv2``, imported lazily),
  for MP4/H.264, MPEG-4, MOV or MKV when cv2 is installed; frames are
  re-encoded to JPEG, and ``fps`` resampling follows ffmpeg's dup/drop
  ``fps=`` filter.

``write_mjpeg_avi`` packages JPEG frames as a minimal MJPEG AVI, the
fixture of the demuxer's tests and of ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Iterator, List, Optional, Tuple


class FFmpegNotFound(RuntimeError):
    pass


class NotMJPEGAVI(RuntimeError):
    pass


def _iter_riff_chunks(data: bytes, start: int, end: int) -> Iterator[
    Tuple[bytes, int, int]
]:
    """Yield (fourcc, payload_start, payload_size) walking a RIFF chunk
    range; descends into LIST chunks (their payload begins with a list
    type fourcc). Chunks are padded to even sizes per the RIFF spec."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        payload = pos + 8
        if fourcc in (b"RIFF", b"LIST"):
            # skip the 4-byte form/list type, then recurse
            yield from _iter_riff_chunks(
                data, payload + 4, min(payload + size, end)
            )
        else:
            yield fourcc, payload, size
        pos = payload + size + (size & 1)


def iter_mjpeg_avi_frames(path: str) -> Iterator[bytes]:
    """Yield each video frame of an MJPEG AVI as raw JPEG bytes.

    Pure-Python RIFF walk: video frames live in ``NNdc``/``NNdb`` chunks
    whose payload is a complete JFIF stream (SOI ``FF D8`` magic
    checked). Raises NotMJPEGAVI for non-AVI input or AVIs whose frame
    chunks are not JPEG (e.g. raw/other codecs).
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise NotMJPEGAVI(f"{path}: not a RIFF/AVI file")
    found = False
    for fourcc, start, size in _iter_riff_chunks(data, 0, len(data)):
        if len(fourcc) == 4 and fourcc[2:4] in (b"dc", b"db") and size > 0:
            payload = data[start : start + size]
            if payload[:2] != b"\xff\xd8":
                raise NotMJPEGAVI(
                    f"{path}: video chunk is not JPEG (codec is not MJPEG)"
                )
            found = True
            yield payload
    if not found:
        raise NotMJPEGAVI(f"{path}: no video frame chunks found")


def extract_frames_mjpeg_avi(
    video_path: str, out_dir: str, pattern: str = "%06d.jpg"
) -> int:
    """Demux an MJPEG AVI into ``out_dir/pattern`` JPEG frames (1-based,
    matching ffmpeg's numbering). Returns the frame count."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i, jpeg in enumerate(iter_mjpeg_avi_frames(video_path)):
        with open(os.path.join(out_dir, pattern % (i + 1)), "wb") as f:
            f.write(jpeg)
        n += 1
    return n


def write_mjpeg_avi(
    path: str, jpeg_frames: List[bytes], width: int, height: int,
    fps: int = 30,
) -> None:
    """Write JPEG byte strings as a minimal spec-conforming MJPEG AVI
    (RIFF(AVI ){LIST(hdrl){avih, LIST(strl){strh,strf}}, LIST(movi)
    {00dc...}, idx1}). Useful for packaging frame dumps as video and as
    the offline test fixture for the demuxer."""

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(list_type: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", list_type + payload)

    n = len(jpeg_frames)
    usec_per_frame = int(1_000_000 / max(fps, 1))
    max_bytes = max((len(j) for j in jpeg_frames), default=0)
    avih = struct.pack(
        "<14I", usec_per_frame, max_bytes * fps, 0, 0x10, n, 0, 1, max_bytes,
        width, height, 0, 0, 0, 0,
    )
    # AVISTREAMHEADER: flags, priority, language, initialFrames, scale,
    # rate, start, length, bufSize, quality, sampleSize, rcFrame (56 B).
    strh = (
        b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps,
                                        0, n, max_bytes, 0, 0)
        + struct.pack("<4H", 0, 0, width, height)
    )
    strf = struct.pack(
        "<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
        width * height * 3, 0, 0, 0, 0,
    )
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi_payload = b"".join(chunk(b"00dc", j) for j in jpeg_frames)
    movi = lst(b"movi", movi_payload)
    # idx1: offsets are relative to the start of the movi list payload
    idx, off = b"", 4
    for j in jpeg_frames:
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(j))
        off += 8 + len(j) + (len(j) & 1)
    body = b"AVI " + hdrl + movi + chunk(b"idx1", idx)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def ffmpeg_path() -> Optional[str]:
    return shutil.which("ffmpeg")


def _cv2():
    """cv2 if importable, else None (kept a hookable module attribute so
    tests can exercise the cv2-less deployment path)."""
    try:
        import cv2  # noqa: PLC0415

        return cv2
    except ImportError:
        return None


class VideoDecodeError(RuntimeError):
    pass


def extract_frames_cv2(
    video_path: str,
    out_dir: str,
    fps: Optional[float] = None,
    quality: int = 2,
    pattern: str = "%06d.jpg",
) -> int:
    """Decode a video through OpenCV's FFmpeg-backed ``VideoCapture``
    and write JPEG frames (1-based, ffmpeg-compatible numbering).

    Covers every codec/container this cv2 build's avcodec decodes —
    H.264/MP4 in particular (the common real-recording case the
    reference handles via the ffmpeg binary). ``fps`` resampling
    reproduces ffmpeg's ``fps=`` filter semantics (dup/drop against a
    virtual output clock). ``quality`` is ffmpeg's ``-q:v`` qscale
    (2 = high); it is mapped onto the JPEG quality scale.

    Returns the number of frames written; raises VideoDecodeError when
    cv2 is unavailable or cannot open/decode the input.
    """
    cv2 = _cv2()
    if cv2 is None:
        raise VideoDecodeError("OpenCV (cv2) is not installed")
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise VideoDecodeError(
            f"{video_path}: cv2.VideoCapture could not open it "
            "(missing file or codec unsupported by this FFmpeg build)"
        )
    os.makedirs(out_dir, exist_ok=True)
    # ffmpeg qscale 2..31 (best..worst) → JPEG quality ~95..8.
    jpeg_q = int(max(8, min(95, round(101 - 3 * max(quality, 2)))))
    enc = [int(cv2.IMWRITE_JPEG_QUALITY), jpeg_q]
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    if src_fps <= 0:
        src_fps = 30.0  # avcodec sometimes reports 0 for odd containers
    n = 0
    next_t = 0.0
    idx = 0

    def write(frame) -> None:
        nonlocal n
        n += 1
        if not cv2.imwrite(os.path.join(out_dir, pattern % n), frame, enc):
            raise VideoDecodeError(
                f"{video_path}: cv2.imwrite failed at frame {n}"
            )

    frame = None
    try:
        while True:
            ok, frame_i = cap.read()
            if not ok:
                break
            frame = frame_i
            if fps is None:
                emit = 1
            else:
                # virtual output clock: emit (dup) while the source
                # timestamp has passed the next output tick, drop when
                # it hasn't reached it yet — ffmpeg's fps filter.
                emit = 0
                t = idx / src_fps
                while t >= next_t - 1e-9:
                    emit += 1
                    next_t += 1.0 / fps
            for _ in range(emit):
                write(frame)
            idx += 1
        if fps is not None and frame is not None:
            # EOF flush: the last source frame holds until the stream's
            # total duration, so upsampling pads trailing output ticks
            # with dups of it (ffmpeg's fps-filter EOF behavior).
            while next_t < idx / src_fps - 1e-9:
                write(frame)
                next_t += 1.0 / fps
    finally:
        cap.release()
    if n == 0:
        raise VideoDecodeError(f"{video_path}: decoded zero frames")
    return n


def extract_frames(
    video_path: str,
    out_dir: str,
    fps: Optional[float] = None,
    quality: int = 2,
    pattern: str = "%06d.jpg",
) -> int:
    """Extract JPEG frames from a video with ffmpeg.

    Args:
      video_path: input video file.
      out_dir: output directory (created); frames land as pattern.
      fps: optional resampling rate (None = native frame rate, which is
        what the reference pipeline uses so gaze txt rows align 1:1).
      quality: JPEG qscale (2 = high quality, ffmpeg's -q:v).

    Returns:
      number of frames written.

    Raises:
      FFmpegNotFound: if no ffmpeg binary is on PATH.
    """
    exe = ffmpeg_path()
    if exe is None:
        # Fallback 1: pure-Python MJPEG AVI demux (native frame rate
        # only — what the reference pipeline uses so gaze txt rows align
        # 1:1). Preferred over cv2 for MJPEG AVIs because the JPEG
        # payloads are stream-copied losslessly instead of re-encoded.
        if not os.path.exists(video_path):
            raise FileNotFoundError(video_path)
        if fps is None:
            try:
                return extract_frames_mjpeg_avi(video_path, out_dir, pattern)
            except NotMJPEGAVI:
                pass
        # Fallback 2: cv2's FFmpeg-backed VideoCapture (any codec this
        # build's avcodec decodes, fps resampling supported).
        try:
            return extract_frames_cv2(
                video_path, out_dir, fps=fps, quality=quality,
                pattern=pattern,
            )
        except VideoDecodeError as e:
            raise FFmpegNotFound(
                "ffmpeg not found on PATH and the built-in fallbacks "
                f"(pure-Python MJPEG-AVI demux, cv2/avcodec decode) could "
                f"not ingest this input ({e}) — install ffmpeg (the "
                "reference pipeline has the same offline dependency) or "
                "pre-extract frames into the images/<video>/ layout."
            ) from e
    os.makedirs(out_dir, exist_ok=True)
    ext = os.path.splitext(pattern)[1] or ".jpg"
    before = {f for f in os.listdir(out_dir) if f.endswith(ext)}
    if before:
        # Stale frames from a previous (possibly longer) extraction
        # would silently mix into the dataset and desync gaze rows —
        # say so loudly instead of inflating the returned count.
        import warnings

        warnings.warn(
            f"extract_frames: {len(before)} pre-existing {ext} files "
            f"under {out_dir!r}; frames not overwritten by this "
            "extraction will MIX with the new ones (clear the directory "
            "for a clean re-extraction)."
        )
    cmd = [exe, "-y", "-i", video_path, "-q:v", str(quality)]
    if fps is not None:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [os.path.join(out_dir, pattern)]
    subprocess.run(cmd, check=True, capture_output=True)
    return len([f for f in os.listdir(out_dir) if f.endswith(ext)])


def extract_dataset(videos_dir: str, images_root: str, **kwargs) -> dict:
    """Extract every video under ``videos_dir`` into the GTEA layout
    ``images_root/<video_stem>/``. Returns {video_stem: frame_count}."""
    results = {}
    for name in sorted(os.listdir(videos_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in (".mp4", ".avi", ".mov", ".mkv", ".mpg"):
            continue
        results[stem] = extract_frames(
            os.path.join(videos_dir, name), os.path.join(images_root, stem), **kwargs
        )
    return results
