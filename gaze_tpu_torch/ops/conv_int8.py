"""The int8 3x3 convolution of the quantized VGG streams: one layer with
its fused epilogue, as plain PyTorch.

Counterpart of one layer of ``gaze_tpu/ops/pallas/conv_int8.py``'s chain
and of the XLA loop body in ``gaze_tpu/models/quant.py:quant_vgg_forward``.
Activations are stored int8 codes in NHWC. A conv pads with a given code
(the real zero: -128 on the zero-point-128 grid of interior layers, 0 on
the signed grid of an int8 stem), sums s8 x s8 products exactly in int32,
and then applies one of two epilogues per output channel:

- requant (``ConvTap.bias is None``), into the next layer's grid:
  ``q = clip(rint(f32(acc) * a + c), -128, 127)`` as int8;
- dequant (``ConvTap.bias`` set; conv5_3), for the float consumers:
  ``y = relu((f32(acc) + c) * a + bias)`` as float32, with
  ``c = zp * col_sum`` and ``a = sx * w_scale``.

The plain version here sums the integer products as a float64
``conv2d`` (exact: |acc| <= 9 * 512 * 128 * 127 < 2^53), casts to int32,
and rounds every epilogue operation on its own (a multiply, then an add:
no fused multiply-add), so the CUDA kernel K3 (``ops/cuda/conv_int8.py``)
is held to it bit for bit. K3 zero-fills the frame's border and adds the
pad code back in its epilogue; :func:`pad_correction` is that step in
plain form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ConvTap:
    """One int8 3x3 conv layer with its epilogue folded.

    w: (Co, 3, 3, Ci) int8, OHWI (the HWIO kernel permuted (3, 0, 1, 2)).
    a, c: (Co,) float32 — see the module docstring.
    bias: None for the requant epilogue; (Co,) float32 for dequant.
    pad_code: the stored code of real zero on the input's grid.
    border: None, or ``border_table(w, pad_code)`` computed once
      (``quant_taps`` does); the kernel's wrapper computes it per call
      otherwise.
    """

    w: torch.Tensor
    a: torch.Tensor
    c: torch.Tensor
    bias: Optional[torch.Tensor] = None
    pad_code: int = -128
    border: Optional[torch.Tensor] = None


def tap_colsum(w: torch.Tensor) -> torch.Tensor:
    """(9, Co) int32: per tap (dy * 3 + dx) and output channel, the sum of
    the OHWI weights over Ci."""
    return w.to(torch.int32).sum(dim=-1, dtype=torch.int32).reshape(w.shape[0], 9).t().contiguous()


def border_class(H: int, W: int, device=None) -> torch.Tensor:
    """(H, W) int64 border class of each pixel: bit 0 top row, bit 1
    bottom row, bit 2 left column, bit 3 right column (0 inside)."""
    y = torch.arange(H, device=device)[:, None]
    x = torch.arange(W, device=device)[None, :]
    return ((y == 0).long() | (y == H - 1).long() << 1
            | (x == 0).long() << 2 | (x == W - 1).long() << 3)


def border_table(w: torch.Tensor, pad_code: int) -> torch.Tensor:
    """(16, Co) int32: per border class, ``pad_code`` times the colsums of
    the taps that leave the frame (top taps dy = 0 on the top row, and so
    on); row 0 is zero."""
    colsum = tap_colsum(w)
    rows = []
    for cls in range(16):
        out = [t for t in range(9)
               if (cls & 1 and t // 3 == 0) or (cls & 2 and t // 3 == 2)
               or (cls & 4 and t % 3 == 0) or (cls & 8 and t % 3 == 2)]
        rows.append(colsum[out].sum(dim=0, dtype=torch.int32) if out
                    else torch.zeros_like(colsum[0]))
    return (torch.stack(rows) * pad_code).contiguous()


def pad_correction(border: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H, W, Co) int32: what padding with the pad code adds to the
    accumulator of a zero-padded conv, from ``border_table``."""
    return border[border_class(H, W, border.device)]


def int8_conv_acc(x: torch.Tensor, w: torch.Tensor, pad_code: int) -> torch.Tensor:
    """Exact int32 accumulator of a 3x3 SAME conv on int8 codes:
    (B, H, W, Ci) x (Co, 3, 3, Ci) -> (B, H, W, Co)."""
    xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (1, 1, 1, 1), value=float(pad_code))
    acc = F.conv2d(xf, w.permute(0, 3, 1, 2).to(torch.float64))
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def epilogue(acc: torch.Tensor, tap: ConvTap) -> torch.Tensor:
    """The tap's requant (-> int8) or dequant (-> float32) epilogue of an
    int32 accumulator, one rounding per operation."""
    accf = acc.to(torch.float32)
    if tap.bias is None:
        y = accf * tap.a
        y = y + tap.c
        return torch.clamp(torch.round(y), -128, 127).to(torch.int8)
    y = accf + tap.c
    y = y * tap.a
    y = y + tap.bias
    return torch.relu(y)


def conv3x3_int8_plain(x: torch.Tensor, tap: ConvTap) -> torch.Tensor:
    """One int8 conv layer with its epilogue: (B, H, W, Ci) int8 ->
    (B, H, W, Co) int8 (requant) or float32 (dequant)."""
    return epilogue(int8_conv_acc(x, tap.w, tap.pad_code), tap)


def maxpool2x2_int8(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of NHWC int8 codes (exact; odd edges are
    dropped, as flax's VALID max_pool does)."""
    B, H, W, C = x.shape
    x = x[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
