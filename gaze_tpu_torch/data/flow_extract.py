"""Offline flow-image extraction: the producer half of dense_flow.

Counterpart of ``gaze_tpu/data/flow_extract.py``. The paper's
preprocessing runs dense_flow (C++/OpenCV/CUDA) over every video to
fill ``<root>/flows/`` with 8-bit quantized TV-L1 flow images that the
temporal stream then reads as images. This module writes the same
layouts with the port's TV-L1 on the card (kernels K1 and K2 for CUDA
tensors; ``dense_flow_tvl1_config()`` is OpenCV's schedule):

    flows/<video>/flow_x_<frame> + flow_y_<frame>   separate grayscale
    flows/<video>/<frame>                           packed (ch0=x, ch1=y)

``data/gtea.py`` reads both. Quantization is ``ops.tvl1.quantize_flow``:
clip to [-bound, bound], map linearly to [0, 255] (zero motion 128 up to
rounding). Frame t's flow image encodes the pair (t-1, t) and is stored
under frame t's name, so frame 0 has none.

Frames are decoded one window of ``batch_size`` pairs at a time (a real
recording of ~15k frames at 720x960 would take ~30 GB as one array); the
window's frames go to the card once and both sides of every pair are
taken from there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from gaze_tpu_torch.core.config import TVL1Config
from gaze_tpu_torch.core.device import resolve_device
from gaze_tpu_torch.data.native_io import decode_batch
from gaze_tpu_torch.ops.image import resize_bilinear
from gaze_tpu_torch.ops.preprocess import resize_nchw, rgb_to_gray, to_float
from gaze_tpu_torch.ops.tvl1 import quantize_flow, tvl1_flow

_FORMATS = ("jpg", "png")
_LAYOUTS = ("xy", "packed")


@dataclasses.dataclass(frozen=True)
class FlowExtractSpec:
    """Knobs of one extraction run."""

    tvl1: TVL1Config
    bound: float                 # quantization clip, +-pixels (dense_flow -b)
    layout: str = "xy"           # "xy" (flow_x_/flow_y_ grayscale) | "packed"
    fmt: str = "jpg"             # "jpg" (dense_flow's choice, lossy) | "png"
    quality: int = 95            # JPEG quality (ignored for png)
    batch_size: int = 32         # frame pairs per solve on the card
    flow_scale: float = 1.0      # solve at this fraction of the native grid
                                 # (1.0 = dense_flow's native-grid solve)

    def __post_init__(self):
        if self.fmt not in _FORMATS:
            raise ValueError(f"fmt must be one of {_FORMATS}, got {self.fmt!r}")
        if self.layout not in _LAYOUTS:
            raise ValueError(
                f"layout must be one of {_LAYOUTS}, got {self.layout!r}")


def make_flow_quant_fn(spec: FlowExtractSpec, hw: Tuple[int, int],
                       device=None) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``fn(prev_u8, cur_u8) -> uint8 (B, H, W, 2)`` quantized flow of
    (B, H, W, 3) uint8 frame pairs, computed on ``device`` (``None``
    means ``cuda``).

    Solves on the native (H, W) grid by default; ``flow_scale < 1``
    solves on the reduced grid as the serving pipeline does (antialiased
    resize of the gray frames, bilinear upsample of the field,
    displacements times 1 / flow_scale).
    """
    dev = resolve_device(device)
    H, W = hw

    @torch.inference_mode()
    def fn(prev_u8: torch.Tensor, cur_u8: torch.Tensor) -> torch.Tensor:
        prev_u8 = torch.as_tensor(prev_u8, device=dev)
        cur_u8 = torch.as_tensor(cur_u8, device=dev)
        if tuple(prev_u8.shape[1:3]) != (H, W) or prev_u8.shape != cur_u8.shape:
            raise ValueError(f"expected two (B, {H}, {W}, 3) batches, got "
                             f"{tuple(prev_u8.shape)}, {tuple(cur_u8.shape)}")
        g0 = rgb_to_gray(to_float(prev_u8))
        g1 = rgb_to_gray(to_float(cur_u8))
        s = spec.flow_scale
        if s != 1.0:
            fhw = (int(round(H * s)), int(round(W * s)))
            lo = tvl1_flow(resize_bilinear(g0, fhw), resize_bilinear(g1, fhw), spec.tvl1,
                           device=dev)
            flow = resize_nchw(lo.permute(0, 3, 1, 2), (H, W)).permute(0, 2, 3, 1) * (1.0 / s)
        else:
            flow = tvl1_flow(g0, g1, spec.tvl1, device=dev)
        return quantize_flow(flow, spec.bound)

    return fn


def _flow_name(image_name: str, fmt: str) -> str:
    """Flow filename for a frame image name: the same name for jpg, the
    stem + .png for png (``build_manifest`` tries both)."""
    if fmt == "jpg":
        return image_name
    return os.path.splitext(image_name)[0] + ".png"


def _cv2():
    """OpenCV if importable, else None. dense_flow writes its flow images
    with ``cv::imwrite``, so cv2 is the byte-level parity choice; PIL is
    the fallback."""
    try:
        import cv2

        return cv2
    except ImportError:
        return None


def _imwrite(arr_rgb_or_gray: np.ndarray, path: str, quality: int) -> None:
    cv2 = _cv2()
    if cv2 is not None:
        a = arr_rgb_or_gray
        if a.ndim == 3:  # cv2 writes BGR: flip so the file decodes as RGB
            a = a[..., ::-1]
        params = (
            [int(cv2.IMWRITE_JPEG_QUALITY), quality]
            if path.endswith((".jpg", ".jpeg")) else []
        )
        if not cv2.imwrite(path, np.ascontiguousarray(a), params):
            raise OSError(f"cv2.imwrite failed for {path!r}")
        return
    from PIL import Image

    img = Image.fromarray(
        arr_rgb_or_gray, mode="L" if arr_rgb_or_gray.ndim == 2 else "RGB"
    )
    if path.endswith(".png"):
        img.save(path)
    else:
        img.save(path, quality=quality)


def _save_gray(arr: np.ndarray, path: str, quality: int) -> None:
    _imwrite(arr, path, quality)


def _save_packed(arr_xy: np.ndarray, path: str, quality: int) -> None:
    """Packed 3-channel image: ch0=x, ch1=y, ch2=128 (unused padding; the
    reader takes the first two channels)."""
    pad = np.full(arr_xy.shape[:2] + (1,), 128, np.uint8)
    _imwrite(np.concatenate([arr_xy, pad], axis=-1), path, quality)


def extract_video_flow(
    image_paths: List[str],
    out_dir: str,
    spec: FlowExtractSpec,
    solve_fn=None,
    device=None,
) -> int:
    """Extract flow images for one video's ordered frame list.

    Returns the number of flow images written (len(image_paths) - 1).
    Each window of frames is copied to ``device`` (``None`` means
    ``cuda``) and solved there by ``solve_fn``, a
    :func:`make_flow_quant_fn` of the frames' size that callers may
    share across videos of one resolution (made here when absent). Every
    window holds ``batch_size`` pairs: the tail is padded by repeating
    its last pair.
    """
    if len(image_paths) < 2:
        return 0
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    probe = decode_batch(image_paths[:1])
    H, W = probe.shape[1:3]
    if solve_fn is None:
        solve_fn = make_flow_quant_fn(spec, (H, W), dev)
    T = len(image_paths)
    written = 0
    B = spec.batch_size
    for s in range(1, T, B):
        idx = list(range(s, min(s + B, T)))
        bidx = idx + [idx[-1]] * (B - len(idx))
        lo = idx[0] - 1
        window = torch.from_numpy(decode_batch(image_paths[lo:idx[-1] + 1])).to(dev)
        cur = torch.tensor([i - lo for i in bidx], device=dev)
        q = solve_fn(window[cur - 1], window[cur]).cpu().numpy()
        for j, i in enumerate(idx):
            name = _flow_name(os.path.basename(image_paths[i]), spec.fmt)
            if spec.layout == "xy":
                _save_gray(q[j, :, :, 0], os.path.join(out_dir, "flow_x_" + name),
                           spec.quality)
                _save_gray(q[j, :, :, 1], os.path.join(out_dir, "flow_y_" + name),
                           spec.quality)
            else:
                _save_packed(q[j], os.path.join(out_dir, name), spec.quality)
            written += 1
    return written


def extract_flow_images(
    data_root: str,
    spec: FlowExtractSpec,
    out_root: Optional[str] = None,
    videos: Optional[Iterable[str]] = None,
    verbose: bool = True,
    device=None,
) -> int:
    """dense_flow's offline pass over ``<data_root>/images/`` on the card.

    Writes ``<out_root or data_root/flows>/<video>/...`` flow images for
    every consecutive frame pair of every (or the given) video. Gaze and
    fixsac annotations are not needed. ``device=None`` means ``cuda``
    (an error without it); ``"cpu"`` runs the plain path. Returns the
    number of flow images written.
    """
    dev = resolve_device(device)
    images_dir = os.path.join(data_root, "images")
    if not os.path.isdir(images_dir):
        raise FileNotFoundError(f"extract_flow: no images/ directory under {data_root!r}")
    out_root = out_root or os.path.join(data_root, "flows")
    vids = sorted(videos) if videos is not None else sorted(
        d for d in os.listdir(images_dir)
        if os.path.isdir(os.path.join(images_dir, d))
    )
    total = 0
    solvers = {}  # (H, W) -> solve function, shared across videos
    for v in vids:
        vdir = os.path.join(images_dir, v)
        paths = [os.path.join(vdir, n) for n in sorted(os.listdir(vdir))]
        if len(paths) < 2:
            continue
        hw = decode_batch(paths[:1]).shape[1:3]
        if hw not in solvers:
            solvers[hw] = make_flow_quant_fn(spec, hw, dev)
        n = extract_video_flow(paths, os.path.join(out_root, v), spec, solve_fn=solvers[hw],
                               device=dev)
        total += n
        if verbose:
            print({"extract_flow": v, "flow_images": n, "out": os.path.join(out_root, v)})
    return total
