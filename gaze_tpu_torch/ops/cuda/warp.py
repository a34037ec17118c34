"""Wrapper of kernel K1 (``csrc/warp.cu``): the TV-L1 warp of I1 and its
gradients with the per-warp epilogue fused in.

Replaces ``gaze_tpu/ops/pallas/warp.py:warp_fields``. The source note in
``csrc/warp.cu`` gives the bound (10 x 4 B per pixel moved per call) and
the design. The plain version is ``gaze_tpu_torch.ops.warp.warp3_plain``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gaze_tpu_torch.ops.cuda.build import INT, PTR, CudaKernel
from gaze_tpu_torch.ops.warp import warp3_plain

KERNEL = CudaKernel("warp.cu", "warp3_launch", [PTR] * 10 + [INT] * 4 + [PTR])


def check_fields(fields: Sequence[torch.Tensor]) -> None:
    """Every field (B, H, W) float32 contiguous, one shape and device, and
    none requiring grad; H, W >= 2 (the 4-tap gather and the divergence
    need two pixels)."""
    ref = fields[0]
    if ref.dim() != 3 or ref.shape[1] < 2 or ref.shape[2] < 2:
        raise ValueError(f"expected (B, H, W) with H, W >= 2, got {tuple(ref.shape)}")
    for t in fields:
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError("fields differ in shape or device")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fields must be contiguous")
        if t.requires_grad:
            raise ValueError("the kernels have no backward: no field may require grad")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")


def warp3(
    i1: torch.Tensor,
    i1x: torch.Tensor,
    i1y: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    i0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i1wx, i1wy, grad, rho_c) of one TV-L1 warp; see ``warp3_plain``.

    CPU tensors take the plain version; CUDA tensors launch K1.
    """
    fields = (i1, i1x, i1y, u1, u2, i0)
    check_fields(fields)
    if u1.device.type == "cpu":
        return warp3_plain(*fields)
    outs = tuple(torch.empty_like(u1) for _ in range(4))
    B, H, W = u1.shape
    KERNEL.launch(
        *(t.data_ptr() for t in fields + outs), B, H, W, u1.device.index,
        torch.cuda.current_stream(u1.device).cuda_stream,
    )
    return outs
