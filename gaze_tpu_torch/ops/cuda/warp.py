"""Wrapper of kernel K1 (``csrc/warp.cu``): the TV-L1 warp of I1 and of
the gradients it forms from I1 itself, with the per-warp epilogue fused in.

Replaces ``gaze_tpu/ops/pallas/warp.py:warp_fields`` (with the
``central_gradient`` that fed it). The source note in ``csrc/warp.cu``
gives the bound (8 x 4 B per pixel moved per call) and the design. The
plain version is ``gaze_tpu_torch.ops.warp.warp3_plain``.

The launch path is kept thin, since at the solver's shapes the host's
cost of a call exceeds the kernel's device time: one pass of checks, the
raw stream handle, ten ``ctypes`` arguments, and no allocation in
``warp3_into``, which writes the caller's buffer (the solver allocates
one per pyramid level); ``warp3`` allocates it per call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gaze_tpu_torch.ops.cuda.build import INT, PTR, CudaKernel
from gaze_tpu_torch.ops.warp import warp3_plain

KERNEL = CudaKernel("warp.cu", "warp3_launch", [PTR] * 5 + [INT] * 4 + [PTR])


def _refuse(fields: Sequence[torch.Tensor]) -> None:
    """Raise the error that the first bad field earns."""
    ref = fields[0]
    for t in fields:
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError("fields differ in shape or device")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fields must be contiguous")
        if t.requires_grad:
            raise ValueError("the kernels have no backward: no field may require grad")


def check_fields(fields: Sequence[torch.Tensor]) -> int:
    """Every field (B, H, W) float32 contiguous, one shape and device, and
    none requiring grad; H, W >= 2 (the 4-tap gather and the divergence
    need two pixels). Returns the fields' CUDA device index, or -1 for
    CPU tensors. One pass; the error comes from ``_refuse``."""
    ref = fields[0]
    shape, device = ref.shape, ref.device
    if len(shape) != 3 or shape[1] < 2 or shape[2] < 2:
        raise ValueError(f"expected (B, H, W) with H, W >= 2, got {tuple(shape)}")
    f32 = torch.float32
    if ref.dtype is not f32 or ref.requires_grad or not ref.is_contiguous():
        _refuse(fields)
    for t in fields[1:]:
        if (t.dtype is not f32 or t.requires_grad or not t.is_contiguous()
                or t.shape != shape or t.device != device):
            _refuse(fields)
    if device.type == "cuda":
        return device.index
    if device.type == "cpu":
        return -1
    raise ValueError(f"unsupported device {device}")


def warp3_into(
    out: torch.Tensor, i1: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, i0: torch.Tensor
) -> None:
    """Write (i1wx, i1wy, grad, rho_c) of one TV-L1 warp (see
    ``warp3_plain``) into the planes of ``out``, a (4, B, H, W) float32
    tensor beside the fields. The solver keeps one such buffer for the
    warps of a pyramid level, since each warp's fields are spent by its
    primal-dual call before the next warp.

    CPU tensors take the plain version; CUDA tensors launch K1.
    """
    index = check_fields((i1, u1, u2, i0))
    B, H, W = u1.shape
    if (out.shape != (4, B, H, W) or out.dtype is not torch.float32
            or not out.is_contiguous() or out.device != u1.device or out.requires_grad):
        raise ValueError(f"out must be a (4, {B}, {H}, {W}) float32 contiguous tensor on "
                         f"{u1.device} that does not require grad")
    if index < 0:
        torch.stack(warp3_plain(i1, u1, u2, i0), out=out)
        return
    KERNEL.launch(
        i1.data_ptr(), u1.data_ptr(), u2.data_ptr(), i0.data_ptr(), out.data_ptr(),
        B, H, W, index, torch._C._cuda_getCurrentRawStream(index),
    )


def warp3(
    i1: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, i0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i1wx, i1wy, grad, rho_c) of one TV-L1 warp, the planes of one new
    (4, B, H, W) buffer; see :func:`warp3_into`."""
    out = u1.new_empty((4, *u1.shape))
    warp3_into(out, i1, u1, u2, i0)
    return out.unbind()
