"""Gaze overlays: heatmap blend, gaze marker, overlay video.

The port's copy of ``gaze_tpu/utils/viz.py`` (numpy and PIL only),
writing through the port's own MJPEG AVI writer
(``data/video.py:write_mjpeg_avi``), so it needs no ffmpeg or OpenCV;
the output plays in stock players and reads back through the port's
demuxer.
"""

from __future__ import annotations

import io
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

# Marker palette: green ring/dot with a black halo so the marker stays
# visible over both bright frames and the red heatmap blend.
_MARKER_RGB = (0.0, 255.0, 64.0)


def overlay_gaze_frame(
    frame: np.ndarray,
    gaze_xy: Optional[Tuple[float, float]] = None,
    heatmap: Optional[np.ndarray] = None,
    alpha: float = 0.45,
    radius: Optional[float] = None,
) -> np.ndarray:
    """Composite one (H, W, 3) uint8 frame with an optional predicted
    heatmap (any resolution; min-max normalized, blended as red) and an
    optional gaze marker at ``gaze_xy`` in PIXEL coordinates of
    ``frame`` (ring + center dot). Returns uint8."""
    from PIL import Image

    img = np.asarray(frame, np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"frame must be (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    if heatmap is not None:
        hm = np.asarray(heatmap, np.float32)
        if hm.shape != (h, w):
            hm = np.asarray(
                Image.fromarray(hm, mode="F").resize((w, h), Image.BILINEAR),
                np.float32,
            )
        hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-8)
        a = alpha * hm[..., None]
        red = np.zeros_like(img)
        red[..., 0] = 255.0
        img = (1.0 - a) * img + a * red
    if gaze_xy is not None and gaze_xy[0] >= 0 and gaze_xy[1] >= 0:
        gx, gy = float(gaze_xy[0]), float(gaze_xy[1])
        r = float(radius) if radius else max(4.0, 0.025 * max(h, w))
        yy, xx = np.ogrid[:h, :w]
        d = np.sqrt((xx - gx) ** 2 + (yy - gy) ** 2)
        halo = (d <= r + 3.0) & (d >= r - 2.5)
        ring = (d <= r + 1.5) & (d >= r - 1.0)
        dot = d <= max(1.5, r / 4.0)
        img[halo] = 0.0
        img[ring | dot] = _MARKER_RGB
    return img.clip(0.0, 255.0).astype(np.uint8)


def write_overlay_video(
    path: str,
    frames: Iterable[np.ndarray],
    fps: int = 24,
    quality: int = 90,
) -> int:
    """Encode composited uint8 frames to an MJPEG AVI at ``path``
    (streaming JPEG encode — frames may be a generator). Returns the
    frame count."""
    from PIL import Image

    from gaze_tpu_torch.data.video import write_mjpeg_avi

    jpegs = []
    size = None
    for fr in frames:
        arr = np.asarray(fr, np.uint8)
        if size is None:
            size = (arr.shape[1], arr.shape[0])
        elif (arr.shape[1], arr.shape[0]) != size:
            raise ValueError("all overlay frames must share one size")
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    if size is None:
        raise ValueError("no frames to write")
    write_mjpeg_avi(path, jpegs, size[0], size[1], fps=fps)
    return len(jpegs)


def render_gaze_track(
    frame_paths: Sequence[str],
    gazes: Sequence[Tuple[float, float]],
    heatmaps: Optional[Sequence[Optional[np.ndarray]]] = None,
    alpha: float = 0.45,
) -> Iterable[np.ndarray]:
    """Lazily composite native-resolution frames (read from disk) with
    per-frame gaze points (native pixel coords; negative = no marker)
    and optional model-grid heatmaps. Yields uint8 frames in order."""
    from PIL import Image

    for i, p in enumerate(frame_paths):
        img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        hm = heatmaps[i] if heatmaps is not None else None
        yield overlay_gaze_frame(img, gazes[i], hm, alpha=alpha)
