"""The int8 VALID convolutions of the quantized fuse/decoder tail, as one
s8 x s8 -> s32 matrix product each.

Counterpart of the ``lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)`` calls of
``gaze_tpu/models/quant_tail.py:quant_tail_forward``: XLA convolutions in
the JAX package, not a Pallas kernel. A k x k VALID conv of an NHWC int8
input (already padded by the caller) is the product of its im2col matrix,
the k*k shifted views concatenated along the channels in (dy, dx, ci)
order, (B*Ho*Wo, k*k*Ci), with the kernel reshaped to that order, given
here as (Co, k*k*Ci) (the HWIO kernel reshaped to (k*k*Ci, Co) and
transposed). Only k = 1 (the fuse and out convs) and k = 2 (the
polyphase upsample convs) occur.

On the card the product is ``torch._int_mm``, whose CUDA route takes more
than 16 rows and a depth and a width that are multiples of 8: the
operands are padded with zero rows and columns (which add nothing to the
sums) and the result sliced back, so the out conv's single channel runs
as 8. The plain version, taken for CPU tensors, sums the same products
as a float64 matrix product and casts to int32; it is exact, since
|acc| <= 4 * 512 * 128 * 127 < 2^53 (float32 is not: 127 * 128 * 2048 >
2^24).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm's CUDA shape rules: rows > 16, depth and width % 8 == 0.
MIN_ROWS = 17
ALIGN = 8


def im2col_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, Ci) int8 -> (B*(H-k+1)*(W-k+1), k*k*Ci), tap-major in
    (dy, dx, ci) order: the A operand of a k x k VALID conv."""
    b, h, w, ci = x.shape
    ho, wo = h - k + 1, w - k + 1
    if k == 1:
        return x.reshape(b * h * w, ci)
    cols = [x[:, dy:dy + ho, dx:dx + wo] for dy in range(k) for dx in range(k)]
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, k * k * ci)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_padded(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` in int32 by ``torch._int_mm``, the operands padded with
    zeros to its CUDA shape rules: a (M, K), w (N, K) int8 -> (M, N)."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, MIN_ROWS), _round_up(k, ALIGN), _round_up(n, ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    # the B operand column-major: the transposed view of a row-major (N, K)
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def conv_valid_int8_plain(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version: the exact float64 product of the same operands."""
    b, h, wd, _ = x.shape
    a = im2col_valid(x, k)
    acc = (a.double() @ w.double().t()).to(torch.int32)
    return acc.reshape(b, h - k + 1, wd - k + 1, w.shape[0])


def conv_valid_int8(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """k x k VALID conv of NHWC int8 ``x`` with the (Co, k*k*Ci) int8
    kernel ``w``: (B, H-k+1, W-k+1, Co) int32 accumulators. ``torch._int_mm``
    for CUDA tensors, the plain version for CPU tensors."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 2 or w.shape[1] != k * k * x.shape[-1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(w.shape)} do not make a "
                         f"{k}x{k} conv")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.device.type == "cpu":
        return conv_valid_int8_plain(x, w, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, h, wd, _ = x.shape
    acc = int_mm_padded(im2col_valid(x, k), w)
    return acc.reshape(b, h - k + 1, wd - k + 1, w.shape[0])
