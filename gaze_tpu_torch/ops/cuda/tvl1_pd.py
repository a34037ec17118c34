"""Wrapper of kernel K2 (``csrc/tvl1_pd.cu``): ``iters`` TV-L1
primal-dual iterations of one (level, warp) step, and its plain version.

Replaces ``gaze_tpu/ops/pallas/tvl1_pd.py:pd_iterations``. The source
note in ``csrc/tvl1_pd.cu`` gives the bound (16 x 4 B per pixel moved
per call) and the design: one launch per iteration over ping-pong
buffers, the loop over ``iters`` here in the wrapper.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaze_tpu_torch.ops.cuda.build import FLOAT, INT, PTR, CudaKernel
from gaze_tpu_torch.ops.cuda.warp import check_fields
from gaze_tpu_torch.ops.image import divergence, forward_gradient

_EPS_GRAD = 1e-9

KERNEL = CudaKernel(
    "tvl1_pd.cu", "tvl1_pd_launch", [PTR] * 16 + [INT] * 3 + [FLOAT] * 3 + [INT, PTR]
)

Carry = Tuple[torch.Tensor, ...]


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
    *, iters: int, tau: float, lambda_: float, theta: float,
) -> Carry:
    """Run ``iters`` primal-dual iterations. All args (B, H, W) float32.

    Returns the updated (u1, u2, p11, p12, p21, p22). CPU tensors take
    the plain version; CUDA tensors launch K2 once per iteration, from the
    inputs into two ping-pong sets of outputs.
    """
    args = (u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c)
    check_fields(args)
    if u1.device.type == "cpu":
        return pd_iterations_plain(
            *args, iters=iters, tau=tau, lambda_=lambda_, theta=theta
        )
    B, H, W = u1.shape
    stream = torch.cuda.current_stream(u1.device).cuda_stream
    carry, frozen = args[:6], args[6:]
    bufs = [tuple(torch.empty_like(u1) for _ in range(6)) for _ in range(min(iters, 2))]
    for it in range(iters):
        out = bufs[it % 2]
        KERNEL.launch(
            *(t.data_ptr() for t in carry + frozen + out), B, H, W,
            lambda_ * theta, tau / theta, theta, u1.device.index, stream,
        )
        carry = out
    return carry
