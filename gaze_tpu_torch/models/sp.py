"""SP — two-stream saliency-prediction encoder-decoder.

Counterpart of ``gaze_tpu/models/sp.py``: VGG16 over normalized RGB and
over the normalized flow image, channel concat at conv5_3 -> 1x1 conv ->
ReLU, then ConvTranspose(4, stride 2)+BN+ReLU blocks up to the input
grid, a 1x1 conv to one channel and a sigmoid. Returns the saliency map
and the spatial stream's conv5 features (what AT pools).

NHWC at the public methods, NCHW inside. ``forward`` normalizes the
decoder's BatchNorm with its running statistics (inference);
``forward_train`` normalizes with the batch's statistics and returns the
updated running statistics without storing them, as flax's
``mutable=["batch_stats"]`` does:

- the statistics are float32 (for bf16 activations too), the variance
  the biased ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-5;
- running = 0.99 * running + 0.01 * batch (flax momentum 0.99, which is
  torch's momentum 0.01; torch's own update takes the unbiased
  variance, flax's the biased one);
- under a data ``mesh`` (each rank holding its rows of the global
  batch) the statistics are the global batch's, as XLA computes them
  for a sharded batch: the per-rank sums that make ``mean`` and
  ``mean2`` are all-reduced by a collective that autograd
  differentiates (its backward all-reduces the gradient), so each
  rank's gradient through the statistics is the global one.

``cfg.remat`` recomputes activations in the backward pass instead of
storing them (``torch.utils.checkpoint``): "encoders" for both VGG
streams, "full" for the decoder too. It changes no value.

``dtype`` is the activation type (flax's ``dtype``, parameters float32):
convolutions run in it; BatchNorm normalizes in float32 against its
float32 statistics and returns ``dtype``, as flax's does; the logits go
to float32 before the sigmoid, and the conv5 features return as float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gaze_tpu_torch.core.config import SPConfig
from gaze_tpu_torch.core.distributed import all_reduce_sum_grad
from gaze_tpu_torch.models.vgg import VGG16Features, conv

BN_MOMENTUM = 0.99   # flax's: running = m * running + (1 - m) * batch
REMAT_MODES = ("none", "encoders", "full")


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
        return self._run(x, None)

    def forward_train(self, x: torch.Tensor, mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train-mode BatchNorm (global statistics under a ``mesh``):
        (logits, new running statistics keyed by state-dict name), the
        statistics detached."""
        stats: Dict[str, torch.Tensor] = {}
        return self._run(x, stats, mesh), stats

    def _run(self, x: torch.Tensor, stats, mesh=None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        for i in range(len(self.cfg.decoder_channels)):
            d = getattr(self, f"deconv{i + 1}")
            x = F.conv_transpose2d(x, d.weight.to(dt), d.bias.to(dt), stride=2, padding=1)
            if self.cfg.use_batchnorm:
                bn = getattr(self, f"bn{i + 1}")
                if stats is None:
                    x = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                                     bn.bias, False, 0.0, bn.eps).to(dt)
                else:
                    x = _batch_norm_train(x, bn, f"bn{i + 1}", stats, mesh).to(dt)
            x = F.relu(x)
        return conv(self.out_conv, x)


def _batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, name: str, stats,
                      mesh=None) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False)`` on NCHW ``x``: float32
    batch statistics over (B, H, W) (the global batch's under a
    ``mesh``), the fast biased variance clipped at 0; the new running
    statistics go into ``stats``."""
    xf = x.float()
    if mesh is None:
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
    else:
        sums = all_reduce_sum_grad(
            torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]), mesh)
        n = xf.numel() // xf.shape[1] * mesh.size
        mean, mean2 = (sums / n).chunk(2)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
    with torch.no_grad():
        stats[f"{name}.running_mean"] = (
            BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
        stats[f"{name}.running_var"] = (
            BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    return y + bn.bias[:, None, None]


class SPNet(nn.Module):
    """Two-stream SP: (rgb (B,H,W,3), flow (B,H,W,2)) -> (saliency
    (B,H,W), spatial conv5 (B,h,w,C5))."""

    def __init__(self, cfg: SPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {cfg.remat!r}")
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
        return torch.sigmoid(self.decoder(self._fuse(f_spatial, f_temporal)).float())[:, 0]

    def _fuse(self, f_spatial: torch.Tensor, f_temporal: torch.Tensor) -> torch.Tensor:
        fused = torch.cat([f_spatial, f_temporal], dim=-1).permute(0, 3, 1, 2)
        return F.relu(conv(self.fuse_conv, fused.to(self.dtype).contiguous()))

    def forward_train(
        self, rgb: torch.Tensor, flow: torch.Tensor, mesh=None
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward: (saliency, spatial conv5, the decoder's
        new BatchNorm running statistics keyed by state-dict name). The
        module's own statistics are left as they are; ``cfg.remat``
        applies; BatchNorm takes the global batch's statistics under a
        data ``mesh``."""
        if self.cfg.remat == "none":
            f_spatial, f_temporal = self.encode(rgb, flow)
        else:
            f_spatial = checkpoint(self.spatial, rgb, use_reentrant=False)
            f_temporal = checkpoint(self.temporal, flow, use_reentrant=False)
        sal, stats = self.fuse_decode_train(f_spatial, f_temporal, mesh)
        return sal, f_spatial.float(), stats

    def fuse_decode_train(
        self, f_spatial: torch.Tensor, f_temporal: torch.Tensor, mesh=None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`fuse_decode` with train-mode BatchNorm: (saliency, the
        decoder's new running statistics keyed by state-dict name), the
        module's own left as they are. With ``remat="full"`` the decoder
        runs under ``checkpoint``."""
        fused = self._fuse(f_spatial, f_temporal)
        if self.cfg.remat == "full":
            logits, stats = checkpoint(self.decoder.forward_train, fused, mesh,
                                       use_reentrant=False)
        else:
            logits, stats = self.decoder.forward_train(fused, mesh)
        stats = {f"decoder.{k}": v for k, v in stats.items()}
        return torch.sigmoid(logits.float())[:, 0], stats
