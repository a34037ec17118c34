"""LF — late-fusion conv head.

Counterpart of ``gaze_tpu/models/lf.py``: the SP saliency map and the AT
attention map, stacked as two channels, go through 3x3 conv+ReLU layers
and a 3x3 conv to one channel, then a sigmoid.

``dtype`` is the activation type (flax's ``dtype``, parameters float32):
the convs run in it and the logits go to float32 before the sigmoid.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaze_tpu_torch.core.config import LFConfig
from gaze_tpu_torch.models.vgg import conv


class LateFusion(nn.Module):
    """(B, H, W, 2) maps -> (B, H, W) final gaze heatmap.

    ``padding="zero"`` pads each conv with zeros (parity); ``"edge"``
    replicate-pads and convolves VALID. ``residual`` adds the stack's
    output to the saliency logit.
    """

    def __init__(self, cfg: LFConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.padding not in ("zero", "edge"):
            raise ValueError(f"unknown LF padding {cfg.padding!r}")
        self.cfg = cfg
        self.dtype = dtype
        pad = 0 if cfg.padding == "edge" else 1
        c = 2
        for i, ch in enumerate(cfg.channels):
            self.add_module(f"conv{i + 1}", nn.Conv2d(c, ch, 3, padding=pad))
            c = ch
        self.out_conv = nn.Conv2d(c, 1, 3, padding=pad)
        if cfg.residual:
            # The stack starts as an exact zero correction.
            nn.init.zeros_(self.out_conv.weight)

    def _conv(self, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.padding == "edge":
            x = F.pad(x, (1, 1, 1, 1), mode="replicate")
        return conv(m, x)

    def forward(self, maps: torch.Tensor) -> torch.Tensor:
        maps = maps.to(self.dtype)
        x = maps.permute(0, 3, 1, 2).contiguous()
        for i in range(len(self.cfg.channels)):
            x = F.relu(self._conv(getattr(self, f"conv{i + 1}"), x))
        logits = self._conv(self.out_conv, x).float()[:, 0]
        if self.cfg.residual:
            sal = torch.clamp(maps[..., 0].float(), 1e-6, 1 - 1e-6)
            logits = logits + torch.log(sal) - torch.log1p(-sal)
        return torch.sigmoid(logits)
