"""Bilinear sampling / backward warping — the plain version of kernel K1.

Counterpart of ``gaze_tpu/ops/warp.py``: the exact border-clamped 4-tap
gather. ``warp3_plain`` is what the CUDA kernel ``csrc/warp.cu``
computes (the warp of I1 and its two gradients with shared weights, plus
the TV-L1 per-warp epilogue), written as tensor ops; the kernel's wrapper
(``ops/cuda/warp.py``) runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _corners(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Clamped coordinates -> (flat index of the top-left tap, fx, fy)."""
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    # Clamp the integer corner so x0+1 / y0+1 stay in range.
    x0i = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0i = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = x - x0i.to(x.dtype)
    fy = y - y0i.to(y.dtype)
    return y0i * W + x0i, fx, fy


def _gather4(img: torch.Tensor, base: torch.Tensor, fx, fy) -> torch.Tensor:
    B, H, W = img.shape
    flat = img.reshape(B, H * W)

    def gather(offset):
        return torch.gather(flat, 1, (base + offset).reshape(B, H * W)).reshape(B, H, W)

    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    return gather(0) * w00 + gather(1) * w01 + gather(W) * w10 + gather(W + 1) * w11


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W) ``img`` at absolute coordinates (x along W, y
    along H), border-clamped."""
    B, H, W = img.shape
    base, fx, fy = _corners(x, y, H, W)
    return _gather4(img, base, fx, fy)


def _grid(u1: torch.Tensor, u2: torch.Tensor):
    B, H, W = u1.shape
    gx = torch.arange(W, dtype=u1.dtype, device=u1.device).view(1, 1, W)
    gy = torch.arange(H, dtype=u1.dtype, device=u1.device).view(1, H, 1)
    return gx + u1, gy + u2


def warp_backward(img: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + u(p)) for (B, H, W) img and x/y displacements."""
    x, y = _grid(u1, u2)
    return bilinear_sample(img, x, y)


def warp3_plain(
    i1: torch.Tensor,
    i1x: torch.Tensor,
    i1y: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    i0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp I1 and its gradients by (u1, u2) with one set of weights and
    return the per-warp solver fields (``gaze_tpu/ops/tvl1.py:110-113``):

      i1wx, i1wy            the warped gradients,
      grad = i1wx² + i1wy²  their squared magnitude,
      rho_c = i1w - i1wx·u1 - i1wy·u2 - i0, the constant residual.
    """
    B, H, W = u1.shape
    x, y = _grid(u1, u2)
    base, fx, fy = _corners(x, y, H, W)
    i1w = _gather4(i1, base, fx, fy)
    i1wx = _gather4(i1x, base, fx, fy)
    i1wy = _gather4(i1y, base, fx, fy)
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
    return i1wx, i1wy, grad, rho_c
