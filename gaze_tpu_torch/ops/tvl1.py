"""Pyramidal dual TV-L1 optical flow (Zach, Pock, Bischof 2007 as in
Sanchez et al., IPOL 2013) with fixed level/warp/iteration counts.

Counterpart of ``gaze_tpu/ops/tvl1.py``. Per (level, warp) the solver
warps I1 and its gradients (kernel K1, ``ops/cuda/warp.py``), runs the
primal-dual iterations and the between-warp median (kernel K2,
``ops/cuda/tvl1_pd.py``, one launch for both), or their plain versions
when the config asks for them. CUDA tensors go through the kernels, CPU
tensors through their plain versions.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gaze_tpu_torch.core.config import TVL1Config
from gaze_tpu_torch.core.device import resolve_device
from gaze_tpu_torch.ops.cuda import tvl1_pd, warp
from gaze_tpu_torch.ops.image import (
    central_gradient,
    median3x3,
    pyramid_downscale,
    resize_bilinear,
)
from gaze_tpu_torch.ops.warp import warp3_plain


def _median_passes(cfg: TVL1Config) -> int:
    """3x3 median passes after each warp: none, one, or two chained
    passes for median_kernel=5."""
    if not cfg.median_filter:
        return 0
    return 2 if cfg.median_kernel >= 5 else 1


def _pyramid_shapes(h: int, w: int, levels: int, factor: float) -> List[Tuple[int, int]]:
    """Pyramid geometry, finest first; stops before a side drops below 16."""
    shapes = [(h, w)]
    for _ in range(1, levels):
        nh, nw = int(round(shapes[-1][0] * factor)), int(round(shapes[-1][1] * factor))
        if nh < 16 or nw < 16:
            break
        shapes.append((nh, nw))
    return shapes


def _warp3(i1, i1x, i1y, u1, u2, i0, cfg: TVL1Config):
    """(i1wx, i1wy, grad, rho_c) of one warp: kernel K1 unless the config
    asks for the plain version."""
    if cfg.use_pallas_warp:
        return warp.warp3(i1, i1x, i1y, u1, u2, i0)
    return warp3_plain(i1, i1x, i1y, u1, u2, i0)


def _solve_level(
    i0: torch.Tensor,
    i1: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    cfg: TVL1Config,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cfg.warps`` warps x ``cfg.iters`` primal-dual iterations at one
    pyramid level; all fields (B, H, W)."""
    i1x, i1y = central_gradient(i1)
    p11 = torch.zeros_like(u1)
    p12 = torch.zeros_like(u1)
    p21 = torch.zeros_like(u1)
    p22 = torch.zeros_like(u1)
    passes = _median_passes(cfg)
    kw = dict(iters=cfg.iters, tau=cfg.tau, lambda_=cfg.lambda_, theta=cfg.theta)
    for _ in range(cfg.warps):
        # The flow is frozen during the inner iterations (warping scheme).
        i1wx, i1wy, grad, rho_c = _warp3(i1, i1x, i1y, u1, u2, i0, cfg)
        args = (u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c)
        if cfg.use_pallas_pd:   # K2 applies the median after its last iteration
            u1, u2, p11, p12, p21, p22 = tvl1_pd.pd_iterations(*args, median_passes=passes, **kw)
        else:
            u1, u2, p11, p12, p21, p22 = tvl1_pd.pd_iterations_plain(*args, **kw)
            for _ in range(passes):
                u1, u2 = median3x3(u1), median3x3(u2)
    return u1, u2


def tvl1_flow(
    i0: torch.Tensor, i1: torch.Tensor, cfg: TVL1Config | None = None, device=None
) -> torch.Tensor:
    """Dense TV-L1 optical flow from frame i0 to i1.

    Args:
      i0, i1: (B, H, W) grayscale frames in [0, 1], float32.
      cfg: solver configuration.
      device: where to solve; ``None`` means ``cuda`` (an error when
        CUDA is absent). Inputs are moved there.

    Returns:
      (B, H, W, 2) flow in pixels (x-displacement, y-displacement).
    """
    cfg = cfg or TVL1Config()
    dev = resolve_device(device)
    if i0.dim() != 3 or i0.shape != i1.shape:
        raise ValueError(f"expected two (B, H, W), got {tuple(i0.shape)}, {tuple(i1.shape)}")
    B, H, W = i0.shape
    # The lambda/tau/theta defaults are tuned for the [0, 255] range.
    i0 = torch.as_tensor(i0, dtype=torch.float32, device=dev) * 255.0
    i1 = torch.as_tensor(i1, dtype=torch.float32, device=dev) * 255.0
    shapes = _pyramid_shapes(H, W, cfg.pyramid_levels, cfg.pyramid_factor)

    pyr0 = [i0]
    pyr1 = [i1]
    for s in shapes[1:]:
        pyr0.append(pyramid_downscale(pyr0[-1], s, cfg.presmooth_sigma))
        pyr1.append(pyramid_downscale(pyr1[-1], s, cfg.presmooth_sigma))

    # Coarse-to-fine solve.
    ch, cw = shapes[-1]
    u1 = torch.zeros((B, ch, cw), dtype=i0.dtype, device=dev)
    u2 = torch.zeros_like(u1)
    for lvl in range(len(shapes) - 1, -1, -1):
        u1, u2 = _solve_level(pyr0[lvl], pyr1[lvl], u1, u2, cfg)
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            sx = nw / shapes[lvl][1]
            sy = nh / shapes[lvl][0]
            u1 = resize_bilinear(u1, (nh, nw)) * sx
            u2 = resize_bilinear(u2, (nh, nw)) * sy
    return torch.stack([u1, u2], dim=-1)


def quantize_flow(flow: torch.Tensor, bound: float) -> torch.Tensor:
    """Float flow -> uint8 as dense_flow stores flow images: clip to
    [-bound, bound], map linearly to [0, 255], round half to even."""
    q = torch.clamp(flow, -bound, bound)
    return torch.round((q + bound) * (255.0 / (2.0 * bound))).to(torch.uint8)


def dequantize_flow(q: torch.Tensor, bound: float) -> torch.Tensor:
    """Inverse of :func:`quantize_flow` (lossy: the 8-bit flow-image
    format)."""
    return q.to(torch.float32) * (2.0 * bound / 255.0) - bound
