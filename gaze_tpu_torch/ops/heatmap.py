"""Heatmap post-processing: argmax gaze decode and min-max normalize.

Counterpart of ``gaze_tpu/ops/heatmap.py:39-54``.
"""

from __future__ import annotations

import torch


def heatmap_argmax(hm: torch.Tensor) -> torch.Tensor:
    """(B, H, W) heatmaps -> (B, 2) float32 (x, y) of the maximum. Ties
    go to the first maximum in row-major order, as ``jnp.argmax``."""
    B, H, W = hm.shape
    idx = torch.argmax(hm.reshape(B, H * W), dim=1)
    y = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    x = (idx % W).to(torch.float32)
    return torch.stack([x, y], dim=1)


def normalize_map(hm: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Min-max normalize each (H, W) map of a (B, H, W) batch to [0, 1]."""
    mn = torch.amin(hm, dim=(1, 2), keepdim=True)
    mx = torch.amax(hm, dim=(1, 2), keepdim=True)
    return (hm - mn) / (mx - mn + eps)
