"""Resize + normalize + grayscale + flow input packing, on the device.

Counterpart of ``gaze_tpu/ops/preprocess.py``; frames stay NHWC at the
function boundaries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gaze_tpu_torch.core.config import ImageConfig

# ITU-R BT.601 luma weights (OpenCV's RGB->GRAY, what dense_flow feeds
# its TV-L1 solver).
_LUMA = (0.299, 0.587, 0.114)


def to_float(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return img_u8.to(torch.float32) * (1.0 / 255.0)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float -> (..., H, W) luma, BT.601."""
    w = torch.tensor(_LUMA, dtype=rgb.dtype, device=rgb.device)
    return torch.tensordot(rgb, w, dims=([-1], [0]))


def resize_nchw(x: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize of an NCHW batch with ``jax.image.resize``'s
    semantics: half-pixel centres, and a triangle filter widened by the
    scale on a shrinking axis (antialiasing). ``F.interpolate`` applies
    the widened filter only with ``antialias=True``; on a growing axis
    the two options agree, so it is asked for only when an axis shrinks.
    """
    h, w = x.shape[-2:]
    oh, ow = int(shape[0]), int(shape[1])
    if (h, w) == (oh, ow):
        return x
    return F.interpolate(
        x, size=(oh, ow), mode="bilinear", align_corners=False,
        antialias=oh < h or ow < w,
    )


def resize_frames(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize (B, H, W, C) -> (B, height, width, C); no-op when
    already at target size."""
    if tuple(frames.shape[1:3]) == (height, width):
        return frames
    x = resize_nchw(frames.permute(0, 3, 1, 2), (height, width))
    return x.permute(0, 2, 3, 1).contiguous()


def normalize_rgb(rgb: torch.Tensor, cfg: ImageConfig) -> torch.Tensor:
    """ImageNet normalization for the spatial stream."""
    mean = torch.tensor(cfg.mean, dtype=rgb.dtype, device=rgb.device)
    std = torch.tensor(cfg.std, dtype=rgb.dtype, device=rgb.device)
    return (rgb - mean) / std


def normalize_flow_image(flow_q: torch.Tensor) -> torch.Tensor:
    """Flow image scaled to [0,1] -> the zero-centred temporal input
    (0.5 encodes zero motion in dense_flow's 8-bit format)."""
    return (flow_q - 0.5) / 0.226


def prepare_temporal_input(flow: torch.Tensor, bound: float) -> torch.Tensor:
    """Float flow (B, H, W, 2) in pixels -> normalized temporal input,
    clipped to the 8-bit flow image's [-bound, bound] range."""
    q = torch.clamp(flow, -bound, bound) * (0.5 / bound) + 0.5
    return normalize_flow_image(q)
