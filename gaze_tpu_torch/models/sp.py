"""SP — two-stream saliency-prediction encoder-decoder.

Counterpart of ``gaze_tpu/models/sp.py``: VGG16 over normalized RGB and
over the normalized flow image, channel concat at conv5_3 -> 1x1 conv ->
ReLU, then ConvTranspose(4, stride 2)+BN+ReLU blocks up to the input
grid, a 1x1 conv to one channel and a sigmoid. Returns the saliency map
and the spatial stream's conv5 features (what AT pools).

NHWC at the public methods, NCHW inside. The decoder's BatchNorm uses
its running statistics (inference; call ``.eval()``).

``dtype`` is the activation type (flax's ``dtype``, parameters float32):
convolutions run in it; BatchNorm normalizes in float32 against its
float32 statistics and returns ``dtype``, as flax's does; the logits go
to float32 before the sigmoid, and the conv5 features return as float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaze_tpu_torch.core.config import SPConfig
from gaze_tpu_torch.models.vgg import VGG16Features, conv


class Decoder(nn.Module):
    """len(channels) ConvTranspose x2 blocks, then a 1x1 conv to logits.

    flax's ``ConvTranspose(4, strides=2, padding="SAME")`` doubles the
    grid; torch's ``ConvTranspose2d(4, stride=2, padding=1)`` with the
    taps flipped (the weight bridge flips them) computes the same.
    """

    def __init__(self, cfg: SPConfig, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = in_channels
        for i, ch in enumerate(cfg.decoder_channels):
            self.add_module(
                f"deconv{i + 1}", nn.ConvTranspose2d(c, ch, 4, stride=2, padding=1)
            )
            if cfg.use_batchnorm:
                self.add_module(f"bn{i + 1}", nn.BatchNorm2d(ch, eps=1e-5))
            c = ch
        self.out_conv = nn.Conv2d(c, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW features -> (B, 1, H, W) logits."""
        dt = self.dtype
        x = x.to(dt)
        for i in range(len(self.cfg.decoder_channels)):
            d = getattr(self, f"deconv{i + 1}")
            x = F.conv_transpose2d(x, d.weight.to(dt), d.bias.to(dt), stride=2, padding=1)
            if self.cfg.use_batchnorm:
                bn = getattr(self, f"bn{i + 1}")
                x = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, False, 0.0, bn.eps).to(dt)
            x = F.relu(x)
        return conv(self.out_conv, x)


class SPNet(nn.Module):
    """Two-stream SP: (rgb (B,H,W,3), flow (B,H,W,2)) -> (saliency
    (B,H,W), spatial conv5 (B,h,w,C5))."""

    def __init__(self, cfg: SPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c5 = cfg.stages[-1][-1]
        self.spatial = VGG16Features(3, cfg.stages, dtype)
        self.temporal = VGG16Features(cfg.flow_channels, cfg.stages, dtype)
        self.fuse_conv = nn.Conv2d(2 * c5, cfg.fused_channels, 1)
        self.decoder = Decoder(cfg, cfg.fused_channels, dtype)

    def forward(
        self, rgb: torch.Tensor, flow: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        f_spatial, f_temporal = self.encode(rgb, flow)
        return self.fuse_decode(f_spatial, f_temporal), f_spatial.float()

    def encode(
        self, rgb: torch.Tensor, flow: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both streams' conv5 features, NHWC."""
        return self.spatial(rgb), self.temporal(flow)

    def fuse_decode(self, f_spatial: torch.Tensor, f_temporal: torch.Tensor) -> torch.Tensor:
        """conv5 features of both streams (NHWC) -> saliency (B, H, W)."""
        fused = torch.cat([f_spatial, f_temporal], dim=-1).permute(0, 3, 1, 2)
        fused = F.relu(conv(self.fuse_conv, fused.to(self.dtype).contiguous()))
        return torch.sigmoid(self.decoder(fused).float())[:, 0]
