"""VGG16 convolutional backbone through conv5_3 + ReLU.

Counterpart of ``gaze_tpu/models/vgg.py``: only the first four max-pools
are applied, so a 224x224 input gives 14x14x512 conv5 features. NHWC at
the boundary. Inside, a bf16 or fp16 stream on the card runs every layer
channels_last, the layout of cuDNN's tensor-core convolutions, so that no
layout transpose surrounds them in the forward or the backward, and each
layer as one convolution that adds the bias and applies the ReLU before
its one store (``conv_bias_relu``); float32 (cuDNN's FFT and NCHW
kernels) and the CPU run NCHW, each layer a convolution and a ReLU.

``dtype`` is the activation and compute type (flax's ``dtype``); the
parameters stay float32 (``param_dtype``) and are cast per call, as
flax promotes them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaze_tpu_torch.utils.profiling import count

# (channels per conv in each stage); a max-pool follows every stage but
# the last.
VGG16_STAGES: Tuple[Tuple[int, ...], ...] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)


def _nhwc_route(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether a stream computing in ``dtype`` on ``device`` runs its
    layers channels_last: on the card in bf16 and fp16, whose cuDNN
    convolutions are NHWC-native."""
    return device.type == "cuda" and dtype in (torch.bfloat16, torch.float16)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in ``x``'s dtype: weight and bias cast to it."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, m.stride, m.padding, m.dilation, m.groups)


# cuDNN's convolution that adds the bias to its float32 accumulator and
# applies the ReLU before it rounds and stores the output once (CUDA only)
_fused_conv_relu = torch.ops.aten.cudnn_convolution_relu


class _ConvBiasReLU(torch.autograd.Function):
    """``relu(conv2d(x, w, b))`` as ``_fused_conv_relu``. The backward is
    the kernels autograd runs for the plain ops: the ReLU's mask on the
    output, then one convolution backward with the bias gradient."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        y = _fused_conv_relu(x, w, b, stride, padding, dilation, groups)
        ctx.save_for_backward(x, w, y)
        ctx.conv = (stride, padding, dilation, groups)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conv
        g = torch.ops.aten.threshold_backward(gy, y, 0)
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]], stride, padding, dilation, False, [0, 0], groups,
            list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None, None, None


def conv_bias_relu(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``F.relu(conv(m, x))``: on the NHWC route one ``_ConvBiasReLU``,
    with the weight and bias cast to ``x``'s dtype outside it, so that the
    float32 parameters get their gradients through the casts."""
    if not _nhwc_route(x.device, x.dtype):
        return F.relu(conv(m, x))
    return _ConvBiasReLU.apply(x, m.weight.to(x.dtype), m.bias.to(x.dtype), m.stride,
                               m.padding, m.dilation, m.groups)


class VGG16Features(nn.Module):
    """(B, H, W, Cin) -> (B, H/16, W/16, C5) conv5_3 features.

    Layer names are ``conv{s}_{i}``, the keys of the weight bridge.
    """

    def __init__(
        self,
        in_channels: int,
        stages: Tuple[Tuple[int, ...], ...] = VGG16_STAGES,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.stages = tuple(tuple(s) for s in stages)
        c = in_channels
        for s, stage in enumerate(self.stages):
            for i, ch in enumerate(stage):
                self.add_module(f"conv{s + 1}_{i + 1}", nn.Conv2d(c, ch, 3, padding=1))
                c = ch

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, H, W) -> (B, C5, H/16, W/16); each layer keeps ``x``'s
        memory format."""
        x = x.to(self.dtype)
        for s, stage in enumerate(self.stages):
            for i in range(len(stage)):
                x = conv_bias_relu(getattr(self, f"conv{s + 1}_{i + 1}"), x)
            if s < len(self.stages) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # channels_last: the NCHW view of the NHWC input (free where it is
        # contiguous) in, a contiguous NHWC tensor out; autograd carries
        # the layout into the backward
        fmt = torch.contiguous_format
        if _nhwc_route(x.device, self.dtype):
            count("sp.nhwc_streams")
            fmt = torch.channels_last
        y = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous(memory_format=fmt))
        return y.permute(0, 2, 3, 1)
