"""Wrapper of kernel K3 (``csrc/conv_int8.cu``): one int8 3x3 conv layer
with its requant or dequant epilogue fused, and optionally the 2x2
max-pool that ends a VGG stage.

Replaces ``gaze_tpu/ops/pallas/conv_int8.py:conv3x3_int8_chain`` and, on
the card, the XLA int8 convolutions of ``gaze_tpu/models/quant.py``
(PyTorch has no int8 convolution on CUDA). K3 is an implicit GEMM on
Hopper's ``wgmma`` fed by TMA; TMA fills the frame's border with 0, so
the kernel adds the pad code's share back in its epilogue from a table
per border class (``ConvTap.border``, computed here when the tap has
none). The source note in ``csrc/conv_int8.cu`` gives the bound and
the design. The plain version is
``gaze_tpu_torch.ops.conv_int8.conv3x3_int8_plain`` (then
``maxpool2x2_int8`` when pooled); its zero-padded accumulator plus
``pad_correction`` is the kernel's arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from gaze_tpu_torch.ops.conv_int8 import (
    ConvTap, border_table, conv3x3_int8_plain, maxpool2x2_int8)
from gaze_tpu_torch.ops.cuda.build import INT, PTR, CudaKernel

KERNEL = CudaKernel("conv_int8.cu", "conv3x3_int8_launch", [PTR] * 7 + [INT] * 8 + [PTR])

# The least K step of the kernel: 32 input channels, one wgmma k32.
CI_STEP = 32


def block_shape(B: int, H: int, W: int, ci: int, co: int) -> Tuple[int, int]:
    """(BK, BN): the input channels per K step and the output channels
    per tile of the K3 instantiation that a launch at this layer shape
    takes (``ci`` after :func:`pad_channels`), by the launcher's own rule
    (``csrc/conv_int8.cu``: ``pick_block``). Builds the kernel at first
    use, as a launch does; launches nothing."""
    bk, bn = ctypes.c_int(), ctypes.c_int()
    pint = ctypes.POINTER(ctypes.c_int)
    err = KERNEL.query("conv3x3_int8_block", [INT] * 5 + [pint, pint])(
        B, H, W, ci, co, ctypes.byref(bk), ctypes.byref(bn))
    if err != 0:
        raise ValueError(f"K3 takes no launch at {(B, H, W, ci, co)}")
    return bk.value, bn.value


def pad_channels(tap: ConvTap) -> ConvTap:
    """A tap whose Ci is a multiple of ``CI_STEP``: zero weights on the
    added channels, so their input codes add nothing (the int8 stem's
    Ci = 3 or 2). The input is padded to match in :func:`conv3x3_int8`."""
    ci = tap.w.shape[-1]
    if ci % CI_STEP == 0:
        return tap
    w = F.pad(tap.w, (0, -ci % CI_STEP))
    return ConvTap(w.contiguous(), tap.a, tap.c, tap.bias, tap.pad_code, tap.border)


def check(x: torch.Tensor, tap: ConvTap) -> None:
    if x.dtype != torch.int8 or tap.w.dtype != torch.int8:
        raise TypeError(f"expected int8 codes and weights, got {x.dtype}, {tap.w.dtype}")
    if x.dim() != 4 or tap.w.dim() != 4 or tuple(tap.w.shape[1:3]) != (3, 3):
        raise ValueError(f"expected NHWC codes and OHWI 3x3 weights, got "
                         f"{tuple(x.shape)}, {tuple(tap.w.shape)}")
    if x.shape[-1] != tap.w.shape[-1]:
        raise ValueError(f"codes have {x.shape[-1]} channels, weights {tap.w.shape[-1]}")
    co = tap.w.shape[0]
    vecs = [tap.a, tap.c] + ([] if tap.bias is None else [tap.bias])
    for v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError(f"epilogue vectors must be float32 ({co},)")
    for t in [x, tap.w, *vecs]:
        if t.device != x.device:
            raise ValueError("codes, weights and epilogue on different devices")
        if not t.is_contiguous():
            raise ValueError("codes, weights and epilogue must be contiguous")
    if tap.border is not None and (tap.border.dtype != torch.int32
                                   or tuple(tap.border.shape) != (16, co)
                                   or tap.border.device != x.device
                                   or not tap.border.is_contiguous()):
        raise ValueError(f"border must be contiguous int32 (16, {co}) on the codes' device")
    if not -128 <= tap.pad_code <= 127:
        raise ValueError(f"pad code {tap.pad_code} is not an int8")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def conv3x3_int8(x: torch.Tensor, tap: ConvTap, pool: bool = False) -> torch.Tensor:
    """(B, H, W, Ci) int8 codes -> (B, H, W, Co) int8 (requant) or
    float32 (dequant); see ``conv3x3_int8_plain``. ``pool``: a requant
    layer's 2x2 stride-2 max-pool after it, (B, H // 2, W // 2, Co) int8
    (``maxpool2x2_int8``).

    CPU tensors take the plain version; CUDA tensors launch K3 once.
    """
    check(x, tap)
    if pool and tap.bias is not None:
        raise ValueError("the 2x2 max-pool follows a requantizing layer, not a dequantizing one")
    padded = pad_channels(tap)
    if padded is not tap:
        x = F.pad(x, (0, padded.w.shape[-1] - x.shape[-1]))
        tap = padded
    ci = tap.w.shape[-1]
    if x.device.type == "cpu":
        out = conv3x3_int8_plain(x, tap)
        return maxpool2x2_int8(out) if pool else out
    B, H, W, _ = x.shape
    co = tap.w.shape[0]
    if B * H * W * max(ci, co) >= 2**31:
        raise ValueError("tensor too large for 32-bit indexing")
    if x.data_ptr() % 16 or tap.w.data_ptr() % 16:
        raise ValueError("codes and weights must be 16-byte aligned")
    dequant = tap.bias is not None
    border = border_table(tap.w, tap.pad_code) if tap.border is None else tap.border
    shape = (B, H // 2, W // 2, co) if pool else (B, H, W, co)
    out = torch.empty(shape, device=x.device, dtype=torch.float32 if dequant else torch.int8)
    KERNEL.launch(
        x.data_ptr(), tap.w.data_ptr(), tap.a.data_ptr(), tap.c.data_ptr(),
        tap.bias.data_ptr() if dequant else None, border.data_ptr(), out.data_ptr(),
        B, H, W, ci, co, int(dequant), int(pool), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out
