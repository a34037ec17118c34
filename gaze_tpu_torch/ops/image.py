"""Image primitives under the TV-L1 solver: Gaussian blur, pyramid
scaling, gradients, divergence, 3x3 median.

Counterpart of ``gaze_tpu/ops/image.py``. Single-channel fields are
(B, H, W) at every function boundary.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from gaze_tpu_torch.ops.preprocess import resize_nchw


def gaussian_kernel1d(
    sigma: float, radius: int | None = None, device=None
) -> torch.Tensor:
    """Odd-length normalized 1-D Gaussian kernel, radius ceil(2.5 sigma)."""
    if radius is None:
        radius = max(1, int(math.ceil(2.5 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W), edge-padded: along W, then
    along H."""
    k = gaussian_kernel1d(sigma, device=img.device).to(img.dtype)
    r = (k.shape[0] - 1) // 2
    x = img[:, None]
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), k.view(1, 1, -1, 1))
    return x[:, 0]


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W) to (B, *shape), antialiased when it
    shrinks (``jax.image.resize`` semantics)."""
    return resize_nchw(img[:, None], shape)[:, 0]


def pyramid_downscale(
    img: torch.Tensor, shape: Tuple[int, int], sigma: float = 0.8
) -> torch.Tensor:
    """Gaussian presmooth, then bilinear resize (IPOL pyramid step)."""
    return resize_bilinear(gaussian_blur(img, sigma), shape)


def central_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences of (B, H, W) with one-sided borders."""
    gx = torch.cat(
        [
            img[:, :, 1:2] - img[:, :, 0:1],
            0.5 * (img[:, :, 2:] - img[:, :, :-2]),
            img[:, :, -1:] - img[:, :, -2:-1],
        ],
        dim=2,
    )
    gy = torch.cat(
        [
            img[:, 1:2, :] - img[:, 0:1, :],
            0.5 * (img[:, 2:, :] - img[:, :-2, :]),
            img[:, -1:, :] - img[:, -2:-1, :],
        ],
        dim=1,
    )
    return gx, gy


def forward_gradient(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences; zero in the last column / last row (Neumann)."""
    gx = torch.cat([u[:, :, 1:] - u[:, :, :-1], torch.zeros_like(u[:, :, :1])], dim=2)
    gy = torch.cat([u[:, 1:, :] - u[:, :-1, :], torch.zeros_like(u[:, :1, :])], dim=1)
    return gx, gy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the adjoint of ``forward_gradient``:
    column 0 takes p1[0], the last column -p1[W-2]; the same for rows."""
    d1 = torch.cat(
        [p1[:, :, :1], p1[:, :, 1:-1] - p1[:, :, :-2], -p1[:, :, -2:-1]], dim=2
    )
    d2 = torch.cat(
        [p2[:, :1, :], p2[:, 1:-1, :] - p2[:, :-2, :], -p2[:, -2:-1, :]], dim=1
    )
    return d1 + d2


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median of (B, H, W), edge-padded, by the 19-comparator
    median-of-9 network (Smith 1996) over the nine shifted copies."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    H, W = img.shape[1], img.shape[2]
    v = [p[:, dy : dy + H, dx : dx + W] for dy in range(3) for dx in range(3)]
    for i, j in [
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ]:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]
