"""``--infer`` and ``--infer_batch``: raw video in, per-frame gaze track out.

Counterpart of ``gaze_tpu/cli.py:1012-1252``. A video file (MJPEG AVI
through the pure-Python demuxer; other codecs through ffmpeg or cv2,
``data/video.py``) is extracted to a temporary frame directory; a
directory of frames is read as it is. Frames are resized on the host
(PIL bilinear) to the model grid, the serving transport layout, and
driven through a ``StreamServer`` with ``submit()``/``flush()``: the LSTM
state is carried across the whole video and fixation onsets come from
online I-DT on the model's own gaze. The track has one "x y" row per
frame in native pixels; frame 0 has no flow pair and is "-1 -1".

Where the port departs from the JAX CLI, on purpose:

- both servers get the pipeline's ``quant_conv`` (the JAX CLI drops it,
  ``gaze_tpu/cli.py:1054`` and ``:1194``);
- every temporary frame directory is removed in a ``finally``, after
  the overlay has read its frames: on success and on an error, in both
  modes (the JAX ``--infer`` never removes its directory,
  ``gaze_tpu/cli.py:1043``, and ``--infer_batch`` leaks them when an
  exception is raised, ``:1249``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Tuple

import numpy as np

from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.data.native_io import decode_batch
from gaze_tpu_torch.data.video import extract_frames
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.serve import StreamServer
from gaze_tpu_torch.utils.logging import dump_heatmap_png

_VIDEO_EXTS = (".avi", ".mp4", ".m4v", ".mov", ".mkv", ".mpg", ".mpeg")
_FRAME_EXTS = (".jpg", ".jpeg", ".png")
FRAMES_PREFIX = "gaze_infer_frames_"


def _list_frames(frames_dir: str) -> List[str]:
    """Sorted frame-image paths under a per-video directory."""
    return sorted(os.path.join(frames_dir, f) for f in os.listdir(frames_dir)
                  if f.lower().endswith(_FRAME_EXTS))


def _write_track(path: str, gazes, native_wh, model_wh) -> None:
    """Gaze rows in native pixels ("-1 -1" for a frame with no
    prediction)."""
    nw, nh = native_wh
    tw, th = model_wh
    with open(path, "w") as f:
        for gx, gy in gazes:
            if gx < 0:
                f.write("-1 -1\n")
            else:
                f.write(f"{gx * nw / tw:.2f} {gy * nh / th:.2f}\n")


def make_server(cfg: PipelineConfig, pipeline: GazePipeline, streams: int,
                keep_heatmaps: bool = False) -> StreamServer:
    """A server of ``streams`` slots on the pipeline's weights, device and
    options, ``quant_conv`` included."""
    return StreamServer(cfg, pipeline.state_dicts(), max_streams=streams,
                        dtype=pipeline.dtype, keep_heatmaps=keep_heatmaps,
                        quant_sp=pipeline.quant_sp, at_pool=pipeline.at_pool,
                        decoder_impl=pipeline.decoder_impl, quant_conv=pipeline.quant_conv,
                        device=pipeline.device)


def run_infer(args, cfg: PipelineConfig, pipeline: GazePipeline) -> str:
    """``--infer PATH``: the track to ``--infer_out`` (default
    ``<save_dir>/infer_gaze.txt``), every ``--infer_heatmap_every``-th
    heatmap as a PNG under ``--infer_heatmaps``, the overlay video to
    ``--infer_overlay``. Returns the track's path."""
    src = args.infer
    tmp = None
    try:
        frames_dir = src
        if os.path.isfile(src):
            tmp = frames_dir = tempfile.mkdtemp(prefix=FRAMES_PREFIX)
            n = extract_frames(src, frames_dir)
            print({"infer_extracted_frames": n, "frames_dir": frames_dir})
        paths = _list_frames(frames_dir)
        if not paths:
            raise FileNotFoundError(f"--infer: no frames found under {frames_dir}")
        return _infer_frames(args, cfg, pipeline, paths)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _infer_frames(args, cfg: PipelineConfig, pipeline: GazePipeline, paths: List[str]) -> str:
    from PIL import Image

    th, tw = cfg.image.height, cfg.image.width
    # the overlay blends every frame's heatmap, so it needs the maps too
    want_maps = bool(args.infer_heatmaps) or bool(args.infer_overlay)
    server = make_server(cfg, pipeline, 1, keep_heatmaps=want_maps)
    server.attach(0)
    native_wh = None
    results = []

    def take(out) -> None:
        if out is not None:
            results.append((out["gaze"][0], out["heatmap"][0] if want_maps else None))

    for p in paths:
        img = Image.open(p).convert("RGB")
        if native_wh is None:
            native_wh = img.size
        frame = np.array(img.resize((tw, th), Image.BILINEAR), np.uint8)
        take(server.submit(frame[None]))
    take(server.flush())

    nw, nh = native_wh
    out_path = args.infer_out or os.path.join(args.save_dir, "infer_gaze.txt")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    _write_track(out_path, [(g[0], g[1]) for g, _ in results], (nw, nh), (tw, th))
    if args.infer_heatmaps:
        os.makedirs(args.infer_heatmaps, exist_ok=True)
        for i, (_, hm) in enumerate(results):
            if i % args.infer_heatmap_every == 0:
                dump_heatmap_png(os.path.join(args.infer_heatmaps, f"{i:06d}.png"), hm)
    if args.infer_overlay:
        from gaze_tpu_torch.utils.viz import render_gaze_track, write_overlay_video

        gazes = [(-1.0, -1.0) if g[0] < 0 else (g[0] * nw / tw, g[1] * nh / th)
                 for g, _ in results]
        n = write_overlay_video(args.infer_overlay,
                                render_gaze_track(paths, gazes, [hm for _, hm in results]),
                                fps=args.infer_overlay_fps)
        print({"infer_overlay": args.infer_overlay, "overlay_frames": n})
    print({"infer_frames": len(results), "gaze_track": out_path, "native_size": [nw, nh]})
    return out_path


def run_infer_batch(args, cfg: PipelineConfig, pipeline: GazePipeline) -> str:
    """``--infer_batch DIR``: every video file or per-video frame
    directory under DIR is one stream of one server; the streams advance
    in lockstep, frames decoded per tick at the model grid
    (``decode_batch``, grouped by extension), an ended video re-fed its
    last frame (results lag one submit, so detaching would lose its last
    gaze). One ``<stem>.txt`` track per video goes to ``--infer_out``
    when ``--infer`` does not claim that path, else to
    ``<save_dir>/infer_batch/``. Two inputs with one stem are refused.
    Returns the output directory."""
    root = args.infer_batch
    tmp_dirs: List[str] = []
    try:
        videos: List[Tuple[str, List[str]]] = []   # (stem, frame paths)
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if os.path.isfile(path) and name.lower().endswith(_VIDEO_EXTS):
                frames_dir = tempfile.mkdtemp(prefix=f"gaze_batch_{name}_")
                tmp_dirs.append(frames_dir)
                extract_frames(path, frames_dir)
                stem = os.path.splitext(name)[0]
            elif os.path.isdir(path):
                frames_dir, stem = path, name
            else:
                continue
            paths = _list_frames(frames_dir)
            if paths:
                videos.append((stem, paths))
        return _infer_videos(args, cfg, pipeline, root, videos)
    finally:
        for d in tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)


def _infer_videos(args, cfg: PipelineConfig, pipeline: GazePipeline, root: str,
                  videos: List[Tuple[str, List[str]]]) -> str:
    from PIL import Image

    if not videos:
        raise FileNotFoundError(f"--infer_batch: no videos or frame directories under {root!r}")
    stems = [stem for stem, _ in videos]
    dupes = sorted({x for x in stems if stems.count(x) > 1})
    if dupes:
        raise ValueError(
            f"--infer_batch: duplicate output stems {dupes} (e.g. a.avi next to a.mp4 or a "
            "frame directory 'a') would overwrite each other's gaze tracks: rename the inputs")
    th, tw = cfg.image.height, cfg.image.width
    n = len(videos)
    server = make_server(cfg, pipeline, n)
    native_wh = []
    for v, (_, paths) in enumerate(videos):
        server.attach(v)
        with Image.open(paths[0]) as im:
            native_wh.append(im.size)
    lens = [len(p) for _, p in videos]
    tracks: List[List[Tuple[float, float]]] = [[] for _ in videos]

    def take(out) -> None:
        if out is None:
            return
        g = out["gaze"]
        for v in range(n):
            if len(tracks[v]) < lens[v]:
                tracks[v].append((float(g[v, 0]), float(g[v, 1])))

    frame = np.zeros((n, th, tw, 3), np.uint8)
    for t in range(max(lens)):
        # decode_batch picks its route from its first path, so mixed
        # corpora (JPEG frame directories beside PNG ones) go by extension
        groups: Dict[bool, List[int]] = {}
        for v in range(n):
            if t < lens[v]:
                is_jpg = videos[v][1][t].lower().endswith((".jpg", ".jpeg"))
                groups.setdefault(is_jpg, []).append(v)
        for vs in groups.values():
            decoded = decode_batch([videos[v][1][t] for v in vs], target_hw=(th, tw))
            for i, v in enumerate(vs):
                frame[v] = decoded[i]
        take(server.submit(frame.copy()))
    take(server.flush())

    out_dir = (args.infer_out if args.infer_out and not args.infer
               else os.path.join(args.save_dir, "infer_batch"))
    os.makedirs(out_dir, exist_ok=True)
    for v, (stem, _) in enumerate(videos):
        _write_track(os.path.join(out_dir, f"{stem}.txt"), tracks[v], native_wh[v], (tw, th))
    print({"infer_batch_videos": n, "frames": sum(lens), "out_dir": out_dir})
    return out_dir
