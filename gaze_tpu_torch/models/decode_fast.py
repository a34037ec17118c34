"""Polyphase ("pixel-shuffle") and half-resolution forms of the SP decoder.

Counterpart of ``gaze_tpu/models/decode_fast.py``, on the port's
``SPNet`` modules. The canonical decoder upsamples with
ConvTranspose(4x4, stride 2, SAME) blocks; the same trained parameters
evaluate exactly through the polyphase decomposition

    ConvTranspose(K 4x4, s2, SAME)  ==  pad(1) -> Conv(W 2x2, VALID)
                                        -> offset depth-to-space

with ``W[ty, tx, :, (2r+s)*C:(2r+s+1)*C] = K[2*ty + r, 2*tx + s]`` (K in
flax's (kh, kw, I, O) layout, un-flipped). Phase r of an output row uses
the kernel taps {r, r+2} over input pixels {m-1, m} (r=0) or {m, m+1}
(r=1); one 2x2 conv over the once-padded input gives N+1 positions, of
which phase 0 reads [0, N) and phase 1 reads [1, N+1).

- ``fast_fuse_decode`` ("pixelshuffle"): every block in polyphase form;
  equal to the canonical tail up to the float associativity of the BN
  fold.
- ``halfres_fuse_decode`` ("halfres"): the canonical blocks but the
  last, then only the exact even-sample subgrid of the last block,
  out_conv and sigmoid at half resolution, and a 1-channel midpoint
  interleave back to full size. An accuracy knob of the same class as
  the half-grid flow.

Inference only: BatchNorm is folded into the kernels with its running
statistics. The convolutions are stock PyTorch (cuDNN on the card).
Tensors are NCHW inside; the public functions take and return what
``SPNet.fuse_decode`` does (NHWC features in, (B, H, W) saliency out).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from gaze_tpu_torch.models.sp import Decoder, SPNet
from gaze_tpu_torch.models.vgg import conv


def polyphase_kernel(k: torch.Tensor) -> torch.Tensor:
    """(4, 4, I, O) ConvTranspose kernel (flax layout) -> (2, 2, I, 4*O)
    polyphase conv kernel; phase block p = 2r + s holds K[2ty+r, 2tx+s]."""
    kh, kw, i, o = k.shape
    if (kh, kw) != (4, 4):
        raise ValueError(f"polyphase form needs 4x4 kernels, got {tuple(k.shape)}")
    # [ty, r, tx, s, I, O] -> [ty, tx, I, r, s, O]: the output-channel
    # axis orders as (r, s, O), phase-major blocks of width O
    t = k.reshape(2, 2, 2, 2, i, o).permute(0, 2, 4, 1, 3, 5)
    return t.reshape(2, 2, i, 4 * o)


def _depth_to_space_offset(y: torch.Tensor, c: int) -> torch.Tensor:
    """(B, 4C, N+1, M+1) polyphase conv output -> (B, C, 2N, 2M):
    out[2m+r, 2n+s] = y[block(2r+s), m+r, n+s]."""
    b = y.shape[0]
    n, m = y.shape[2] - 1, y.shape[3] - 1
    y00 = y[:, 0 * c:1 * c, :-1, :-1]
    y01 = y[:, 1 * c:2 * c, :-1, 1:]
    y10 = y[:, 2 * c:3 * c, 1:, :-1]
    y11 = y[:, 3 * c:4 * c, 1:, 1:]
    r0 = torch.stack([y00, y01], dim=4).reshape(b, c, n, 2 * m)
    r1 = torch.stack([y10, y11], dim=4).reshape(b, c, n, 2 * m)
    return torch.stack([r0, r1], dim=3).reshape(b, c, 2 * n, 2 * m)


def depth_to_space_offset_nhwc(y: torch.Tensor, c: int) -> torch.Tensor:
    """:func:`_depth_to_space_offset` on NHWC: (B, N+1, M+1, 4C) ->
    (B, 2N, 2M, C), any dtype (the int8 tail moves codes with it)."""
    b = y.shape[0]
    n, m = y.shape[1] - 1, y.shape[2] - 1
    y00 = y[:, :-1, :-1, 0 * c:1 * c]
    y01 = y[:, :-1, 1:, 1 * c:2 * c]
    y10 = y[:, 1:, :-1, 2 * c:3 * c]
    y11 = y[:, 1:, 1:, 3 * c:4 * c]
    r0 = torch.stack([y00, y01], dim=3).reshape(b, n, 2 * m, c)
    r1 = torch.stack([y10, y11], dim=3).reshape(b, n, 2 * m, c)
    return torch.stack([r0, r1], dim=2).reshape(b, 2 * n, 2 * m, c)


def _conv_hwio(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """VALID conv of NCHW ``x`` with an HWIO kernel, in ``x``'s dtype."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1).to(x.dtype))


def upsample2x_block(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """One ConvTranspose(4x4, s2, SAME)-equivalent upsample of NCHW ``x``
    through the polyphase conv; kernel (4, 4, I, O) flax layout, bias (O,)."""
    o = kernel.shape[-1]
    w = polyphase_kernel(kernel.float())
    b4 = bias.float().repeat(4).to(dtype)
    y = _conv_hwio(F.pad(x.to(dtype), (1, 1, 1, 1)), w) + b4[:, None, None]
    return _depth_to_space_offset(y, o)


def _folded_block_params(dec: Decoder, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvTranspose kernel (flax (4, 4, I, O) layout) and bias of block
    i with inference BN folded in: BN(deconv(x)) = deconv_g(x) with k*g,
    (b - mean)*g + beta."""
    d = getattr(dec, f"deconv{i + 1}")
    # the port stores torch's (I, O, kh, kw) with the taps flipped
    k = d.weight.float().flip(2, 3).permute(2, 3, 0, 1)
    b = d.bias.float()
    if not dec.cfg.use_batchnorm:
        return k, b
    bn = getattr(dec, f"bn{i + 1}")
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + 1e-5)
    return k * g, (b - bn.running_mean.float()) * g + bn.bias.float()


def _deconv_flax(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The canonical ConvTranspose(4, s2, SAME) of NCHW ``x`` with a flax
    (4, 4, I, O) kernel, in ``dtype``, the bias added after."""
    w = k.permute(2, 3, 0, 1).flip(2, 3).to(dtype)   # torch's (I, O, kh, kw), flipped
    y = F.conv_transpose2d(x.to(dtype), w, None, stride=2, padding=1)
    return y + b.to(dtype)[:, None, None]


def even_phase_block(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Phase-(0,0) subgrid of a ConvTranspose(4x4, s2, SAME) block: the
    exact even output samples out[::2, ::2], as one 2x2 conv with taps
    K[{0,2}, {0,2}] over the (m-1, m) windows (pad top/left 1)."""
    y = _conv_hwio(F.pad(x.to(dtype), (1, 0, 1, 0)), kernel[::2, ::2])
    return y + bias.to(dtype)[:, None, None]


def _upsample2x_map(m: torch.Tensor) -> torch.Tensor:
    """(B, N, M) map -> (B, 2N, 2M): even rows/cols are the input samples,
    odd ones the midpoint average with the edge clamped."""

    def up1d(x):   # interleave along dim 1
        nxt = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
        mid = 0.5 * (x + nxt)
        return torch.stack([x, mid], dim=2).reshape(x.shape[0], 2 * x.shape[1], *x.shape[2:])

    m = up1d(m)                                    # rows
    return up1d(m.transpose(1, 2)).transpose(1, 2)  # cols


def _fuse(sp: SPNet, f_spatial: torch.Tensor, f_temporal: torch.Tensor, dtype) -> torch.Tensor:
    """1x1 fuse conv + ReLU of the NHWC conv5 features -> NCHW ``dtype``."""
    fused = torch.cat([f_spatial, f_temporal], dim=-1).permute(0, 3, 1, 2).to(dtype)
    return F.relu(conv(sp.fuse_conv, fused.contiguous()))


def halfres_fuse_decode(
    sp: SPNet, f_spatial: torch.Tensor, f_temporal: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Canonical blocks but the last, then the exact even subgrid of the
    last block, out_conv and sigmoid at half resolution, interleaved back
    to full size. NHWC conv5 features -> (B, H, W) saliency."""
    dec = sp.decoder
    n = len(sp.cfg.decoder_channels)
    x = _fuse(sp, f_spatial, f_temporal, dtype)
    for i in range(n - 1):
        k, b = _folded_block_params(dec, i)
        x = F.relu(_deconv_flax(x, k, b, dtype))
    k, b = _folded_block_params(dec, n - 1)
    x = F.relu(even_phase_block(x, k, b, dtype))
    half = torch.sigmoid(conv(dec.out_conv, x).float())[:, 0]
    return _upsample2x_map(half)


def fast_fuse_decode(
    sp: SPNet, f_spatial: torch.Tensor, f_temporal: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``SPNet.fuse_decode`` with every ConvTranspose block in polyphase
    form and BatchNorm folded. NHWC conv5 features -> (B, H, W) saliency."""
    dec = sp.decoder
    x = _fuse(sp, f_spatial, f_temporal, dtype)
    for i in range(len(sp.cfg.decoder_channels)):
        k, b = _folded_block_params(dec, i)
        x = F.relu(upsample2x_block(x, k, b, dtype))
    return torch.sigmoid(conv(dec.out_conv, x).float())[:, 0]
