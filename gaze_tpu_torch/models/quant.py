"""int8 post-training quantization of the SP VGG streams.

Counterpart of ``gaze_tpu/models/quant.py``. The two VGG16 encoders are
quantized here; the fuse/decoder tail stays in the pipeline's dtype
unless a ``QuantTail`` (``models/quant_tail.py``) is calibrated with
them; AT and LF stay in the pipeline's dtype. The streams' scheme,
unchanged:

- weights: per-output-channel symmetric int8, scale = max|w| / 127;
- activations: conv1_1's signed input on a symmetric grid (zero point 0,
  scale = bound / 127); every interior post-ReLU activation on the
  unsigned [0, 255] grid (scale = bound / 255) stored as int8 with zero
  point 128 (stored = q - 128). The zero point folds into the epilogue
  through per-output-channel sums of the int8 kernel;
- SAME padding injects real zeros: the stored code -128 on the interior
  grid;
- bounds are calibrated on representative batches through the float32
  stream: max|x|, or an upper percentile of |x| (linear interpolation,
  as ``jnp.percentile``), aggregated by max over batches;
- each conv sums s8 x s8 products in int32 and requantizes into the next
  layer's grid in one epilogue, ``clip(rint(f32(acc) * a + c), -128,
  127)``; only conv5_3 dequantizes to float32. 2x2 max-pools run on the
  int8 codes (max commutes with the monotone dequant).

With ``bf16_stem`` conv1_1 runs off the unquantized input with bf16
operands and a float32 accumulator, then requantizes into conv1_2's grid.

On the card every int8 conv is kernel K3 (``ops/cuda/conv_int8.py``);
the bf16 stem is a float32 cuDNN conv of bf16-rounded operands, whose
products are exact in float32, and needs TF32 off
(``core/device.py:set_parity_precision``, which ``GazePipeline`` sets).
The port takes the weights from the pipeline's modules, so the
functions here take modules where the JAX ones take ``params``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gaze_tpu_torch.models.sp import SPNet
from gaze_tpu_torch.models.vgg import VGG16_STAGES, VGG16Features
from gaze_tpu_torch.ops.conv_int8 import ConvTap, border_table
from gaze_tpu_torch.ops.cuda.conv_int8 import conv3x3_int8

if TYPE_CHECKING:
    from gaze_tpu_torch.models.quant_tail import QuantTail

LAYERS: Tuple[str, ...] = tuple(
    f"conv{s + 1}_{i + 1}" for s, stage in enumerate(VGG16_STAGES) for i in range(len(stage))
)

# Zero point of every interior (post-ReLU) activation grid; conv1_1's
# signed input uses zero point 0. Stored int8 = q - ZP.
ZP = 128

CONV_IMPLS = ("xla", "pallas")

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class QuantVGG:
    """Quantized parameters and calibrated activation scales of one stream.

    kernels: int8 HWIO; w_scales, biases, col_sums: (O,) float32;
    act_scales: () float32 input scale per layer. ``stem_kernel`` (bf16
    HWIO) and ``stem_bias`` (float32) set select the bf16 stem.
    """

    kernels: Tensors
    w_scales: Tensors
    biases: Tensors
    act_scales: Tensors
    col_sums: Tensors
    stem_kernel: Optional[torch.Tensor] = None
    stem_bias: Optional[torch.Tensor] = None

    def to(self, device) -> "QuantVGG":
        def move(d):
            return {k: v.to(device) for k, v in d.items()}

        return QuantVGG(
            move(self.kernels), move(self.w_scales), move(self.biases),
            move(self.act_scales), move(self.col_sums),
            None if self.stem_kernel is None else self.stem_kernel.to(device),
            None if self.stem_bias is None else self.stem_bias.to(device),
        )


@dataclasses.dataclass(frozen=True)
class QuantSP:
    """Quantized two-stream bundle, plus an optional int8 fuse/decoder
    ``tail``: with one, the whole saliency head runs int8."""

    spatial: QuantVGG
    temporal: QuantVGG
    tail: Optional["QuantTail"] = None

    def to(self, device) -> "QuantSP":
        return QuantSP(self.spatial.to(device), self.temporal.to(device),
                       None if self.tail is None else self.tail.to(device))


def _hwio(vgg: VGG16Features, name: str) -> torch.Tensor:
    return getattr(vgg, name).weight.detach().float().permute(2, 3, 1, 0)


def quantize_vgg_params(vgg: VGG16Features) -> Tuple[Tensors, Tensors, Tensors]:
    """Per-output-channel symmetric int8 quantization of the conv kernels:
    (int8 HWIO kernels, (O,) scales, (O,) biases)."""
    kernels, scales, biases = {}, {}, {}
    for name in LAYERS:
        k = _hwio(vgg, name)
        s = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
        kernels[name] = torch.clamp(torch.round(k / s), -127, 127).to(torch.int8).contiguous()
        scales[name] = s
        biases[name] = getattr(vgg, name).bias.detach().float().clone()
    return kernels, scales, biases


def percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x.ravel(), q)`` (linear interpolation) as XLA
    compiles it inside the JAX package's jitted calibration, where ``q``
    is a constant: the position ``(q / 100) * (n - 1)`` in float32, and
    the interpolation ``lo * w_lo + hi * w_hi`` contracted into a fused
    multiply-add of the ``lo`` term (here: summed in float64, rounded
    once). ``torch.quantile`` refuses inputs above 2^24 elements; a
    full-width calibration batch has more."""
    a = torch.sort(x.reshape(-1).float()).values
    f32 = torch.float32
    n1 = torch.tensor(float(a.numel()), dtype=f32) - 1.0
    pos = (torch.tensor(q, dtype=f32) / 100.0) * n1
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = (1.0 - w_high).to(a.device)
    lo = int(torch.clamp(low, 0, n1))
    hi = int(torch.clamp(high, 0, n1))
    hi_term = (a[hi] * w_high.to(a.device)).double()
    return (a[lo].double() * w_low.double() + hi_term).float()


def vgg_forward_with_maxes(
    vgg: VGG16Features, x: torch.Tensor, percentile: Optional[float] = None
) -> Tuple[torch.Tensor, Tensors]:
    """float32 VGG forward over NHWC ``x`` that also returns each conv
    layer's input bound: max|input|, or its upper ``percentile``."""
    bounds: Tensors = {}
    x = x.float().permute(0, 3, 1, 2)
    li = 0
    for s, stage in enumerate(VGG16_STAGES):
        for _ in stage:
            name = LAYERS[li]
            li += 1
            a = x.abs()
            bounds[name] = a.amax() if percentile is None else percentile_linear(a, percentile)
            conv = getattr(vgg, name)
            x = F.relu(F.conv2d(x, conv.weight.float(), conv.bias.float(), padding=1))
        if s < len(VGG16_STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return x.permute(0, 2, 3, 1), bounds


@torch.inference_mode()
def calibrate_vgg(
    vgg: VGG16Features,
    batches: Sequence[torch.Tensor],
    margin: float = 1.0,
    percentile: Optional[float] = None,
) -> Tensors:
    """Per-layer activation scales from representative NHWC batches: the
    bound of each batch, max over batches, over 127 for conv1_1's signed
    input and over 255 for the interior unsigned grids."""
    if not batches:
        raise ValueError("PTQ calibration needs at least one batch")
    agg: Dict[str, float] = {}
    for b in batches:
        _, m = vgg_forward_with_maxes(vgg, b, percentile)
        for k, v in m.items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    return {
        k: torch.tensor(max(v, 1e-12) * margin / (127.0 if k == LAYERS[0] else 255.0),
                        dtype=torch.float32)
        for k, v in agg.items()
    }


def build_quant_vgg(
    vgg: VGG16Features, act_scales: Tensors, bf16_stem: bool = False
) -> QuantVGG:
    kernels, w_scales, biases = quantize_vgg_params(vgg)
    col_sums = {name: k.float().sum(dim=(0, 1, 2)) for name, k in kernels.items()}
    stem_k = stem_b = None
    if bf16_stem:
        stem_k = _hwio(vgg, LAYERS[0]).to(torch.bfloat16).contiguous()
        stem_b = biases[LAYERS[0]].clone()
    dev = kernels[LAYERS[0]].device
    return QuantVGG(kernels, w_scales, biases,
                    {k: v.to(dev) for k, v in act_scales.items()}, col_sums,
                    stem_k, stem_b)


def quant_taps(q: QuantVGG) -> Dict[str, ConvTap]:
    """Each int8 layer's kernel-ready tap: OHWI weights, the folded
    epilogue and the pad code of its input grid. The algebra is the JAX
    package's, one float32 rounding per operation:
    ``a = (sx * w_scale) / sn``, ``c = (b / sn - 128) + (zp * col_sum) * a``;
    conv5_3 dequantizes with ``a = sx * w_scale``, ``c = zp * col_sum``.
    Each tap carries its border table for K3's pad correction."""
    taps = {}
    for li, name in enumerate(LAYERS):
        if li == 0 and q.stem_kernel is not None:
            continue
        zp = 0 if li == 0 else ZP
        sx = q.act_scales[name]
        w = q.kernels[name].permute(3, 0, 1, 2).contiguous()
        zp_bias = zp * q.col_sums[name] if zp else torch.zeros_like(q.col_sums[name])
        if li < len(LAYERS) - 1:
            sn = q.act_scales[LAYERS[li + 1]]
            a = (sx * q.w_scales[name]) / sn
            c = (q.biases[name] / sn - ZP) + zp_bias * a
            taps[name] = ConvTap(w, a, c, None, -zp, border_table(w, -zp))
        else:
            taps[name] = ConvTap(w, sx * q.w_scales[name], zp_bias, q.biases[name], -zp,
                                 border_table(w, -zp))
    return taps


def quant_vgg_forward(
    q: QuantVGG,
    x: torch.Tensor,
    conv_impl: str = "xla",
    taps: Optional[Dict[str, ConvTap]] = None,
) -> torch.Tensor:
    """int8 VGG16 forward: NHWC input (any float dtype) -> float32 conv5
    features.

    ``conv_impl`` is the JAX package's choice between its XLA and Pallas
    int8 convolutions, which compute the same bits; both run through K3
    here (the plain version for CPU tensors). ``taps`` are
    :func:`quant_taps` of ``q``, computed when not given.
    """
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"unknown conv_impl {conv_impl!r}; expected one of {CONV_IMPLS}")
    taps = quant_taps(q) if taps is None else taps
    x = x.float()
    if q.stem_kernel is None:
        sx0 = q.act_scales[LAYERS[0]]
        xq = torch.clamp(torch.round(x / sx0), -127, 127).to(torch.int8)
    else:
        # bf16 operands, float32 accumulator: the float32 conv of the
        # bf16-rounded input and kernel (exact products), never a bf16
        # conv, whose output would be rounded to bf16.
        xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        k = q.stem_kernel.float().permute(3, 2, 0, 1)
        acc = F.conv2d(xb, k, padding=1).permute(0, 2, 3, 1)
        sn = q.act_scales[LAYERS[1]]
        y = acc / sn
        y = y + (q.stem_bias / sn - ZP)
        xq = torch.clamp(torch.round(y), -128, 127).to(torch.int8)
    xq = xq.contiguous()
    li = 0
    for s, stage in enumerate(VGG16_STAGES):
        for i in range(len(stage)):
            name = LAYERS[li]
            li += 1
            if name in taps:
                # every stage but the last ends in a 2x2 max-pool, which K3
                # fuses into the stage's last conv (never the stem)
                pool = s < len(VGG16_STAGES) - 1 and i == len(stage) - 1
                xq = conv3x3_int8(xq, taps[name], pool=pool)
    return xq


def calibrate_sp(
    sp: SPNet,
    rgb_batches: Sequence[torch.Tensor],
    flow_batches: Sequence[torch.Tensor],
    margin: float = 1.0,
    percentile: Optional[float] = None,
    bf16_stem: bool = False,
    quant_tail: bool = False,
) -> QuantSP:
    """Calibrate and quantize both SP encoder streams from preprocessed
    NHWC rgb and flow inputs. With ``quant_tail`` also the int8
    fuse/decoder tail of ``sp`` (its ``SPConfig`` and BatchNorm running
    statistics), on the float32 conv5 features the QUANTIZED streams give
    for the same batches: the tail's serving input."""
    spatial = build_quant_vgg(
        sp.spatial, calibrate_vgg(sp.spatial, rgb_batches, margin, percentile), bf16_stem)
    temporal = build_quant_vgg(
        sp.temporal, calibrate_vgg(sp.temporal, flow_batches, margin, percentile), bf16_stem)
    tail = None
    if quant_tail:
        from gaze_tpu_torch.models.quant_tail import calibrate_tail

        taps_s, taps_t = quant_taps(spatial), quant_taps(temporal)
        feats = [torch.cat([quant_vgg_forward(spatial, r, taps=taps_s),
                            quant_vgg_forward(temporal, f, taps=taps_t)], dim=-1)
                 for r, f in zip(rgb_batches, flow_batches)]
        tail = calibrate_tail(sp, feats, margin, percentile)
    return QuantSP(spatial, temporal, tail)


def preprocessed_batches(pipeline, frame_pairs) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(rgb, flow) float32 NHWC model inputs of raw uint8 frame pairs
    through the pipeline's own preprocessing. ``frame_pairs``: (prev_u8,
    cur_u8) or (prev_u8, cur_u8, flow_img_u8 or None)."""
    dev = pipeline.device
    rgb_b: List[torch.Tensor] = []
    flow_b: List[torch.Tensor] = []
    with torch.no_grad():
        for pair in frame_pairs:
            fl = pair[2] if len(pair) > 2 else None
            if fl is not None:
                fl = torch.as_tensor(fl, device=dev)
            r, f = pipeline.preprocess_pair(torch.as_tensor(pair[0], device=dev),
                                            torch.as_tensor(pair[1], device=dev), fl)
            rgb_b.append(r.float())
            flow_b.append(f.float())
    return rgb_b, flow_b


@torch.inference_mode()
def calibrate_pipeline_sp(
    pipeline,
    frame_pairs,
    margin: float = 1.0,
    percentile: Optional[float] = None,
    quant_tail: bool = False,
    bf16_stem: bool = False,
) -> QuantSP:
    """Calibrate from raw uint8 frame pairs through the pipeline's own
    preprocessing (resize, normalize, TV-L1 at its flow scale, cast to its
    dtype), so the scales see the serving input distribution.

    frame_pairs: (prev_u8, cur_u8) or (prev_u8, cur_u8, flow_img_u8 or
    None): (B, H, W, 3) frames and an optional (B, h, w, 2) precomputed
    flow image, which takes the TV-L1 solve's place as in ``step``.
    ``quant_tail``: calibrate the int8 fuse/decoder tail too
    (:func:`calibrate_sp`).
    """
    if not frame_pairs:
        raise ValueError("PTQ calibration needs at least one frame pair")
    rgb_b, flow_b = preprocessed_batches(pipeline, frame_pairs)
    return calibrate_sp(pipeline.sp, rgb_b, flow_b, margin, percentile, bf16_stem, quant_tail)
