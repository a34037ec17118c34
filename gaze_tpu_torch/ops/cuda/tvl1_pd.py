"""Wrapper of kernel K2 (``csrc/tvl1_pd.cu``): ``iters`` TV-L1
primal-dual iterations of one (level, warp) step, optionally followed by
the between-warp 3x3 median of the flow, and its plain version.

Replaces ``gaze_tpu/ops/pallas/tvl1_pd.py:pd_iterations``. The source
note in ``csrc/tvl1_pd.cu`` gives the bound (16 x 4 B per pixel moved
per call) and the design: one launch per call, halo'd temporal tiling
with the carry in shared memory, the median fused after the last
iteration.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaze_tpu_torch.ops.cuda.build import FLOAT, INT, PTR, CudaKernel
from gaze_tpu_torch.ops.cuda.warp import check_fields
from gaze_tpu_torch.ops.image import divergence, forward_gradient, median3x3

_EPS_GRAD = 1e-9

KERNEL = CudaKernel(
    "tvl1_pd.cu", "tvl1_pd_launch", [PTR] * 16 + [INT] * 5 + [FLOAT] * 3 + [INT, PTR]
)

# One launch holds a halo of iters + median_passes pixels around its tile
# (at most 41); a longer call is split into launches of MAX_ITERS.
MAX_ITERS = 39
MEDIAN_PASSES = (0, 1, 2)

Carry = Tuple[torch.Tensor, ...]


def tile_side(B: int, H: int, W: int, iters: int, median_passes: int) -> int:
    """The side of the square tile that one K2 launch of ``iters``
    iterations and ``median_passes`` medians at (B, H, W) takes, by the
    launcher's own rule (``csrc/tvl1_pd.cu``: ``pick_tile``); its grid is
    (ceil(W / side), ceil(H / side), B). Builds the kernel at first use,
    as a launch does; launches nothing."""
    side = KERNEL.query("tvl1_pd_tile", [INT] * 5)(B, H, W, iters, median_passes)
    if side == 0:
        raise ValueError(f"K2 takes no launch at {(B, H, W)}, iters={iters}, "
                         f"median_passes={median_passes}")
    return side


def pd_iterations_plain(
    u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c,
    *, iters: int, tau: float, lambda_: float, theta: float,
) -> Carry:
    """The plain PyTorch version: the scan body of
    ``gaze_tpu/ops/tvl1.py:131-159``, iterated ``iters`` times."""
    lt = lambda_ * theta
    taut = tau / theta
    for _ in range(iters):
        # thresholding step (exact minimizer of the linearized data term)
        rho = rho_c + i1wx * u1 + i1wy * u2
        mask_neg = rho < -lt * grad
        mask_pos = rho > lt * grad
        d1 = torch.where(
            mask_neg, lt * i1wx,
            torch.where(mask_pos, -lt * i1wx, -rho * i1wx / (grad + _EPS_GRAD)),
        )
        d2 = torch.where(
            mask_neg, lt * i1wy,
            torch.where(mask_pos, -lt * i1wy, -rho * i1wy / (grad + _EPS_GRAD)),
        )
        # primal update from the dual field
        u1n = (u1 + d1) + theta * divergence(p11, p12)
        u2n = (u2 + d2) + theta * divergence(p21, p22)
        # dual ascent + reprojection onto |p| <= 1
        g1x, g1y = forward_gradient(u1n)
        g2x, g2y = forward_gradient(u2n)
        ng1 = 1.0 + taut * torch.sqrt(g1x * g1x + g1y * g1y)
        ng2 = 1.0 + taut * torch.sqrt(g2x * g2x + g2y * g2y)
        p11 = (p11 + taut * g1x) / ng1
        p12 = (p12 + taut * g1y) / ng1
        p21 = (p21 + taut * g2x) / ng2
        p22 = (p22 + taut * g2y) / ng2
        u1, u2 = u1n, u2n
    return u1, u2, p11, p12, p21, p22


def pd_iterations(
    u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c,
    *, iters: int, tau: float, lambda_: float, theta: float, median_passes: int = 0,
) -> Carry:
    """Run ``iters`` primal-dual iterations, then ``median_passes`` (0, 1
    or 2: ``median_kernel`` 3 or 5) edge-replicated 3x3 medians of u1 and
    u2; the duals take no median. All args (B, H, W) float32.

    Returns the updated (u1, u2, p11, p12, p21, p22). CPU tensors take
    the plain version (``pd_iterations_plain``, then ``median3x3``); CUDA
    tensors launch K2 once (once per ``MAX_ITERS`` iterations beyond),
    from the inputs into new outputs.
    """
    args = (u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c)
    check_fields(args)
    if median_passes not in MEDIAN_PASSES:
        raise ValueError(f"median_passes must be one of {MEDIAN_PASSES}, got {median_passes!r}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"iters must be a non-negative int, got {iters!r}")
    if u1.device.type == "cpu":
        out = pd_iterations_plain(*args, iters=iters, tau=tau, lambda_=lambda_, theta=theta)
        u1, u2 = out[:2]
        for _ in range(median_passes):
            u1, u2 = median3x3(u1), median3x3(u2)
        return (u1, u2, *out[2:])
    B, H, W = u1.shape
    stream = torch.cuda.current_stream(u1.device).cuda_stream
    carry, frozen = args[:6], args[6:]
    left = iters
    while True:
        n = min(left, MAX_ITERS)
        left -= n
        out = tuple(torch.empty_like(u1) for _ in range(6))
        KERNEL.launch(
            *(t.data_ptr() for t in carry + frozen + out), B, H, W, n,
            0 if left else median_passes, lambda_ * theta, tau / theta, theta,
            u1.device.index, stream,
        )
        carry = out
        if not left:
            return carry
