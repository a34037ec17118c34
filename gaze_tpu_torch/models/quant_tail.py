"""int8 quantization of the SP fuse/decoder tail through its polyphase form.

Counterpart of ``gaze_tpu/models/quant_tail.py``, on the port's ``SPNet``.
With a ``QuantTail`` in ``QuantSP.tail`` the whole saliency head runs
int8 after the two int8 VGG streams:

    concat(conv5_s, conv5_t) -> q8 -> 1x1 fuse -> [2x2 polyphase conv
    -> requant -> offset depth-to-space on the codes] x N -> 1x1 out conv
    -> float32 sigmoid

The scheme is the streams' (``models/quant.py``): every tail input is
post-ReLU, so activations sit on the unsigned [0, 255] grid stored int8
with zero point 128; weights are per-output-channel symmetric int8 (per
phase block for the polyphase kernels); BatchNorm is folded into the
kernels with its running statistics (inference only, as
``models/decode_fast.py``); padding injects the real-zero code -128 and
the convs run VALID; ReLU and the requant fold into one clip epilogue,
``clip(rint(f32(acc) * a + c), -128, 127)`` with the JAX package's
float32 algebra, one rounding per operation; only the 1-channel logits
dequantize. Activation bounds come from the float32 polyphase tail
(:func:`tail_forward_with_bounds`), max or an upper percentile of |x|.

The convs are ``ops/int8_gemm.py``: ``torch._int_mm`` on the card, an
exact float64 product on the CPU. The JAX package's functions take flax
variables and the ``SPConfig``; the port's take the module, which holds
both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gaze_tpu_torch.core.config import SPConfig
from gaze_tpu_torch.models.decode_fast import (
    _depth_to_space_offset,
    _folded_block_params,
    depth_to_space_offset_nhwc,
    polyphase_kernel,
)
from gaze_tpu_torch.models.quant import percentile_linear
from gaze_tpu_torch.models.sp import SPNet
from gaze_tpu_torch.ops.int8_gemm import conv_valid_int8

ZP = 128   # every tail activation is post-ReLU: the asymmetric grid

Tensors = Dict[str, torch.Tensor]
Folded = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _layer_names(num_blocks: int) -> Tuple[str, ...]:
    return ("fuse", *(f"up{i + 1}" for i in range(num_blocks)), "out")


def tail_layer_names(cfg: SPConfig) -> Tuple[str, ...]:
    return _layer_names(len(cfg.decoder_channels))


def _hwio(conv: torch.nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0)


@torch.no_grad()
def fold_tail_params(sp: SPNet) -> Folded:
    """The tail's conv stack as float32 (HWIO kernel, bias) pairs: the 1x1
    fuse conv, each upsample block in polyphase form with BatchNorm
    folded, and the 1x1 out conv."""
    folded = {"fuse": (_hwio(sp.fuse_conv), sp.fuse_conv.bias.detach().float())}
    dec = sp.decoder
    for i in range(len(sp.cfg.decoder_channels)):
        k, b = _folded_block_params(dec, i)
        folded[f"up{i + 1}"] = (polyphase_kernel(k), b.repeat(4))
    folded["out"] = (_hwio(dec.out_conv), dec.out_conv.bias.detach().float())
    return folded


def _conv(x: torch.Tensor, k_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """VALID conv of NCHW ``x``, the bias added after (as the JAX tail)."""
    return F.conv2d(x, k_hwio.permute(3, 2, 0, 1)) + bias[:, None, None]


@torch.no_grad()
def tail_forward_with_bounds(
    folded: Folded, cfg: SPConfig, x: torch.Tensor, percentile: Optional[float] = None
) -> Tuple[torch.Tensor, Tensors]:
    """float32 polyphase tail over NHWC concat features: (saliency (B, H,
    W), each conv's input bound, max|x| or its upper ``percentile``)."""
    bounds: Tensors = {}

    def record(name, v):
        a = v.abs()
        bounds[name] = a.amax() if percentile is None else percentile_linear(a, percentile)

    x = x.float().permute(0, 3, 1, 2)
    record("fuse", x)
    x = F.relu(_conv(x, *folded["fuse"]))
    for i in range(len(cfg.decoder_channels)):
        name = f"up{i + 1}"
        record(name, x)
        k, b = folded[name]
        y = _conv(F.pad(x, (1, 1, 1, 1)), k, b)
        x = F.relu(_depth_to_space_offset(y, k.shape[-1] // 4))
    record("out", x)
    logits = _conv(x, *folded["out"])
    return torch.sigmoid(logits)[:, 0], bounds


@dataclasses.dataclass(frozen=True)
class QuantTail:
    """int8 tail parameters and calibrated activation scales, by layer name
    (``tail_layer_names``).

    kernels: int8 HWIO (2x2 polyphase for ``up*``); w_scales, biases,
    col_sums: (O,) float32 (biases BN-folded, col_sums the int8 kernel's
    sum over (h, w, in)); act_scales: () float32 input scale per conv.
    """

    kernels: Tensors
    w_scales: Tensors
    biases: Tensors
    act_scales: Tensors
    col_sums: Tensors
    num_blocks: int = 4

    def to(self, device) -> "QuantTail":
        def move(d):
            return {k: v.to(device) for k, v in d.items()}

        return QuantTail(move(self.kernels), move(self.w_scales), move(self.biases),
                         move(self.act_scales), move(self.col_sums), self.num_blocks)

    def names(self) -> Tuple[str, ...]:
        return _layer_names(self.num_blocks)


def build_quant_tail(sp: SPNet, act_scales: Tensors) -> QuantTail:
    """Quantize the folded tail's kernels per output channel (scale max|k| /
    127, codes rounded half to even) beside the given activation scales."""
    kernels, w_scales, biases, col_sums = {}, {}, {}, {}
    for name, (k, b) in fold_tail_params(sp).items():
        s = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
        q = torch.clamp(torch.round(k / s), -127, 127).to(torch.int8).contiguous()
        kernels[name], w_scales[name], biases[name] = q, s, b.clone()
        col_sums[name] = q.float().sum(dim=(0, 1, 2))
    dev = next(iter(kernels.values())).device
    return QuantTail(kernels, w_scales, biases, {k: v.to(dev) for k, v in act_scales.items()},
                     col_sums, num_blocks=len(sp.cfg.decoder_channels))


@torch.inference_mode()
def calibrate_tail(
    sp: SPNet,
    feature_batches: Sequence[torch.Tensor],
    margin: float = 1.0,
    percentile: Optional[float] = None,
) -> QuantTail:
    """Calibrate from representative concatenated conv5 features (B, h, w,
    2 * C5), the tail's serving input: each batch's bounds, max over
    batches, over 255."""
    if not feature_batches:
        raise ValueError("tail PTQ calibration needs at least one batch")
    folded = fold_tail_params(sp)
    agg: Dict[str, float] = {}
    for b in feature_batches:
        _, m = tail_forward_with_bounds(folded, sp.cfg, b, percentile)
        for k, v in m.items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    scales = {k: torch.tensor(max(v, 1e-12) * margin / 255.0, dtype=torch.float32)
              for k, v in agg.items()}
    return build_quant_tail(sp, scales)


class TailTap(NamedTuple):
    """One tail conv ready for ``conv_valid_int8``: w (Co, k*k*Ci) int8 in
    (dy, dx, ci) order; the requant epilogue's a, c, or for the out conv
    a = sx * w_scale, c = 128 * col_sum and its bias."""

    w: torch.Tensor
    k: int
    a: torch.Tensor
    c: torch.Tensor
    bias: Optional[torch.Tensor] = None


def tail_taps(qt: QuantTail) -> Dict[str, TailTap]:
    """Each layer's GEMM kernel and folded epilogue, with the JAX package's
    float32 algebra (``quant_tail.py:222-233``): ``sw = sx * w_scale``,
    ``a = sw / sn``, ``c = (b / sn - 128) + (128 * col) * a``."""
    names = qt.names()
    taps = {}
    for li, name in enumerate(names):
        k = qt.kernels[name]
        w = k.reshape(-1, k.shape[-1]).t().contiguous()
        sw = qt.act_scales[name] * qt.w_scales[name]
        zp_col = ZP * qt.col_sums[name]
        if name == "out":
            taps[name] = TailTap(w, k.shape[0], sw, zp_col, qt.biases[name])
        else:
            sn = qt.act_scales[names[li + 1]]
            a = sw / sn
            taps[name] = TailTap(w, k.shape[0], a, (qt.biases[name] / sn - ZP) + zp_col * a)
    return taps


def tail_input(tap: TailTap, xq: torch.Tensor) -> torch.Tensor:
    """The GEMM's input of a tail conv on NHWC int8 codes: a 2x2 conv's pads
    once with the real-zero code -128."""
    if tap.k == 2:
        xq = F.pad(xq, (0, 0, 1, 1, 1, 1), value=-ZP)
    return xq.contiguous()


def tail_epilogue(tap: TailTap, acc: torch.Tensor) -> torch.Tensor:
    """int32 accumulators -> the requantized int8 codes (before a
    depth-to-space), or, for the out conv, the float32 sigmoid (B, H, W);
    one float32 rounding per operation."""
    acc = acc.float()
    if tap.bias is not None:
        return torch.sigmoid((acc + tap.c) * tap.a + tap.bias)[..., 0]
    return torch.clamp(torch.round(acc * tap.a + tap.c), -128, 127).to(torch.int8)


def tail_layer(tap: TailTap, xq: torch.Tensor) -> torch.Tensor:
    """One tail conv on NHWC int8 codes (``tail_epilogue``'s output)."""
    return tail_epilogue(tap, conv_valid_int8(tail_input(tap, xq), tap.w, tap.k))


def quantize_tail_input(qt: QuantTail, f_spatial: torch.Tensor,
                        f_temporal: torch.Tensor) -> torch.Tensor:
    """The concatenated conv5 features (taken as float32) as int8 codes on
    the fuse conv's input grid."""
    x = torch.cat([f_spatial, f_temporal], dim=-1).float()
    return (torch.clamp(torch.round(x / qt.act_scales["fuse"]), 0, 255) - ZP).to(torch.int8)


def quant_tail_forward(
    qt: QuantTail,
    f_spatial: torch.Tensor,
    f_temporal: torch.Tensor,
    taps: Optional[Dict[str, TailTap]] = None,
) -> torch.Tensor:
    """int8-resident tail: NHWC conv5 features (any float dtype, taken as
    float32) -> (B, H, W) float32 saliency. ``taps`` are
    :func:`tail_taps` of ``qt``, computed when not given."""
    taps = tail_taps(qt) if taps is None else taps
    xq = quantize_tail_input(qt, f_spatial, f_temporal)
    names = qt.names()
    for name in names[:-1]:
        xq = tail_layer(taps[name], xq)
        if name != "fuse":
            xq = depth_to_space_offset_nhwc(xq, xq.shape[-1] // 4)
    return tail_layer(taps[names[-1]], xq)
