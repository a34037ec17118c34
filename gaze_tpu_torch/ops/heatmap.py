"""Ground-truth heatmap rendering and heatmap post-processing: Gaussian
targets, argmax gaze decode and min-max normalize.

Counterpart of ``gaze_tpu/ops/heatmap.py``.
"""

from __future__ import annotations

import torch


def render_gaussian(
    points: torch.Tensor, height: int, width: int, sigma: float
) -> torch.Tensor:
    """(B, 2) (x, y) pixel points -> (B, height, width) float32
    unit-peak Gaussians ``exp(-d^2 / (2 sigma^2))``, on the points'
    device. Points outside the frame still render their tails."""
    B = points.shape[0]
    dev = points.device
    ys = torch.arange(height, dtype=torch.float32, device=dev).view(1, height, 1)
    xs = torch.arange(width, dtype=torch.float32, device=dev).view(1, 1, width)
    px = points[:, 0].to(torch.float32).reshape(B, 1, 1)
    py = points[:, 1].to(torch.float32).reshape(B, 1, 1)
    d2 = (xs - px) ** 2 + (ys - py) ** 2
    return torch.exp(-d2 / (2.0 * sigma * sigma))


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
