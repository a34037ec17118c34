"""VGG16 convolutional backbone through conv5_3 + ReLU.

Counterpart of ``gaze_tpu/models/vgg.py``: only the first four max-pools
are applied, so a 224x224 input gives 14x14x512 conv5 features. NHWC at
the boundary, NCHW inside.

``dtype`` is the activation and compute type (flax's ``dtype``); the
parameters stay float32 (``param_dtype``) and are cast per call, as
flax promotes them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# (channels per conv in each stage); a max-pool follows every stage but
# the last.
VGG16_STAGES: Tuple[Tuple[int, ...], ...] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in ``x``'s dtype: weight and bias cast to it."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, m.stride, m.padding, m.dilation, m.groups)


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
        x = x.to(self.dtype)
        for s, stage in enumerate(self.stages):
            for i in range(len(stage)):
                x = F.relu(conv(getattr(self, f"conv{s + 1}_{i + 1}"), x))
            if s < len(self.stages) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous())
        return y.permute(0, 2, 3, 1)
