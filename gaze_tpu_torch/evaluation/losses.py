"""Heatmap losses: focal BCE, plain BCE and MSE.

Counterpart of ``gaze_tpu/evaluation/losses.py``. Under a data mesh
``floss`` returns the rank's share of the global batch's loss (see
``train/common.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from gaze_tpu_torch.core.config import LossConfig
from gaze_tpu_torch.core.distributed import all_reduce_sum_
from gaze_tpu_torch.parallel.mesh import Mesh


def floss(
    pred: torch.Tensor,
    target: torch.Tensor,
    cfg: LossConfig | None = None,
    sample_weight: torch.Tensor | None = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Focal BCE between (B, H, W) sigmoid outputs and soft targets in
    [0, 1]: ``-t (1-p)^gamma log p - (1-t) p^gamma log(1-p)``, p clipped
    to [eps, 1-eps] as ``jnp.clip`` clips (its gradient included). ``sample_weight`` (B,) weighs each frame's mean
    (0 drops it) and renormalizes over the weights' sum.

    With a ``mesh``, ``pred`` holds the rank's rows of the global batch
    and the result is their share of the global loss: the sum over the
    rank's rows over the global denominator (the pixel count of every
    rank, or the all-reduced weight sum plus 1e-8), so the shares of
    all ranks add up to the global loss."""
    cfg = cfg or LossConfig()
    # jnp.clip's min/max: a prediction exactly at a bound gets half the
    # gradient, where torch.clamp would pass all of it
    lo, hi = (torch.tensor(v, dtype=pred.dtype, device=pred.device)
              for v in (cfg.eps, 1.0 - cfg.eps))
    p = torch.minimum(torch.maximum(pred, lo), hi)
    t = target
    pos = -t * ((1.0 - p) ** cfg.gamma) * torch.log(p)
    neg = -(1.0 - t) * (p ** cfg.gamma) * torch.log(1.0 - p)
    per_px = pos + neg
    if sample_weight is None:
        if mesh is None:
            return torch.mean(per_px)
        return torch.sum(per_px) / (per_px.numel() * mesh.size)
    w = sample_weight.to(per_px.dtype)
    per_frame = torch.mean(per_px, dim=(1, 2))
    return torch.sum(per_frame * w) / (all_reduce_sum_(torch.sum(w), mesh) + 1e-8)


def bce(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Plain BCE, the gamma = 0 case."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return torch.mean(-target * torch.log(p) - (1.0 - target) * torch.log(1.0 - p))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (the AT LSTM's next-weight regression loss)."""
    return torch.mean((pred - target) ** 2)
