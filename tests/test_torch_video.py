"""The port's video layer (``gaze_tpu_torch/data/video.py``) against the
JAX package's: the MJPEG-AVI writer byte for byte, the pure-Python
demuxer payload for payload, ``extract_frames`` without ffmpeg (the
stream-copy demux, then cv2's decoder) and ``extract_dataset`` into the
GTEA layout, file for file, plus the errors each route raises.
"""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

import gaze_tpu.data.video as jvideo
import gaze_tpu_torch.data.video as video
from gaze_tpu_torch.data.gtea import build_manifest
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)


def jpeg_bytes(rng, hw=(24, 32)):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(buf, format="JPEG",
                                                                         quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jpegs():
    rng = np.random.default_rng(0)
    # odd and even payload sizes: RIFF pads odd chunks to even
    frames = [jpeg_bytes(rng) for _ in range(6)]
    assert {len(f) % 2 for f in frames} == {0, 1}
    return frames


@pytest.fixture
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(video, "ffmpeg_path", lambda: None)
    monkeypatch.setattr(jvideo, "ffmpeg_path", lambda: None)


def tree_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("fps", [30, 25])
def test_writer_is_byte_for_byte_the_jax_writer(tmp_path, jpegs, fps):
    a, b = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    video.write_mjpeg_avi(a, jpegs, 32, 24, fps=fps)
    jvideo.write_mjpeg_avi(b, jpegs, 32, 24, fps=fps)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(video.iter_mjpeg_avi_frames(a)) == list(jvideo.iter_mjpeg_avi_frames(a)) == jpegs


def test_extract_dataset_without_ffmpeg_matches_jax(tmp_path, jpegs, no_ffmpeg):
    """videos/ -> images/<stem>/%06d.jpg through the stream-copy demux:
    the same counts and the same files, which ``build_manifest`` reads."""
    vids = tmp_path / "videos"
    vids.mkdir()
    video.write_mjpeg_avi(str(vids / "Ann_Soup.avi"), jpegs, 32, 24)
    video.write_mjpeg_avi(str(vids / "Ben_Tea.avi"), jpegs[:3], 32, 24)
    (vids / "notes.txt").write_text("not a video")
    got = video.extract_dataset(str(vids), str(tmp_path / "ours" / "images"))
    want = jvideo.extract_dataset(str(vids), str(tmp_path / "theirs" / "images"))
    assert got == want == {"Ann_Soup": 6, "Ben_Tea": 3}
    for stem in got:
        ours = tree_bytes(tmp_path / "ours" / "images" / stem)
        assert ours == tree_bytes(tmp_path / "theirs" / "images" / stem)
        assert list(ours) == ["%06d.jpg" % i for i in range(1, got[stem] + 1)]
    m = build_manifest(str(tmp_path / "ours"))
    assert len(m.frames["Ann_Soup"]) == 6 and not m.frames["Ann_Soup"][0].gaze_valid


def write_cv2_video(path, fourcc, means, size=(32, 32), fps=30.0):
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, size)
    assert w.isOpened(), fourcc
    for m in means:
        w.write(np.full((size[1], size[0], 3), m, np.uint8))
    w.release()


@pytest.mark.parametrize("fps", [None, 10.0, 60.0])
def test_cv2_route_matches_jax(tmp_path, no_ffmpeg, fps):
    """An MP4 goes through cv2's decoder (and ffmpeg's fps dup/drop when
    asked): the same frames, file for file; an XVID AVI is RIFF but not
    MJPEG, so the demuxer passes it on to cv2."""
    mp4 = tmp_path / "clip.mp4"
    write_cv2_video(mp4, "mp4v", list(range(10, 130, 10)))
    n = video.extract_frames(str(mp4), str(tmp_path / "ours"), fps=fps)
    assert n == jvideo.extract_frames(str(mp4), str(tmp_path / "theirs"), fps=fps)
    assert n == {None: 12, 10.0: 4, 60.0: 24}[fps]
    assert tree_bytes(tmp_path / "ours") == tree_bytes(tmp_path / "theirs")
    if fps is None:
        avi = tmp_path / "xvid.avi"
        write_cv2_video(avi, "XVID", [50, 150, 250])
        assert video.extract_frames(str(avi), str(tmp_path / "x")) == 3


def test_errors(tmp_path, no_ffmpeg, monkeypatch):
    payload = b"\x00\x01\x02\x03"   # an AVI whose frame chunk is not JPEG
    chunk = b"00dc" + struct.pack("<I", len(payload)) + payload
    movi = b"LIST" + struct.pack("<I", 4 + len(chunk)) + b"movi" + chunk
    raw = tmp_path / "raw.avi"
    raw.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(movi)) + b"AVI " + movi)
    with pytest.raises(video.NotMJPEGAVI, match="not JPEG"):
        list(video.iter_mjpeg_avi_frames(str(raw)))
    with pytest.raises(video.NotMJPEGAVI, match="not a RIFF"):
        list(video.iter_mjpeg_avi_frames(__file__))
    with pytest.raises(FileNotFoundError):
        video.extract_frames(str(tmp_path / "missing.mp4"), str(tmp_path / "o"))
    bad = tmp_path / "x.mp4"
    bad.write_bytes(b"\x00\x00\x00\x18ftypmp42 not a riff file")
    with pytest.raises(video.FFmpegNotFound, match="images/<video>/"):
        video.extract_frames(str(bad), str(tmp_path / "o"))
    monkeypatch.setattr(video, "_cv2", lambda: None)
    with pytest.raises(video.VideoDecodeError, match="not installed"):
        video.extract_frames_cv2(str(bad), str(tmp_path / "o"))
