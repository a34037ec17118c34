"""AAE / AUC gaze metrics, batched on the device.

Counterpart of ``gaze_tpu/evaluation/metrics.py``. Both metrics are
reductions over a (B, H, W) heatmap batch, so a rollout scores every
frame on the device and copies only the sums to the host.

Conventions held equal to the JAX package:

- the angle is chord-based, ``2 asin(|a - b| / 2)`` between unit rays;
- the focal length is computed in float32 (``jnp.tan`` of a float32
  angle), not in Python's float64;
- the GT pixel is rounded half to even, and AUC counts the GT pixel in
  its own tie set and in the H·W denominator;
- AUC divides by H·W as the compiled JAX version does (a multiplication
  by the float32 reciprocal), so the scores are equal, not one ulp off.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaze_tpu_torch.core.config import CameraConfig
from gaze_tpu_torch.ops.heatmap import heatmap_argmax


def pixel_to_ray(points: torch.Tensor, grid_hw: Tuple[int, int], cam: CameraConfig) -> torch.Tensor:
    """(B, 2) (x, y) pixel coords on a ``grid_hw`` grid -> (B, 3) unit
    viewing rays of a pinhole camera: focal length from the horizontal
    field of view at the native resolution, principal point at the
    centre, square pixels."""
    gh, gw = grid_hw
    points = points.to(torch.float32)
    sx = cam.native_width / gw
    sy = cam.native_height / gh
    half_fov = torch.deg2rad(torch.tensor(cam.fov_x_deg, dtype=torch.float32)) / 2.0
    f = (cam.native_width / 2.0) / torch.tan(half_fov)
    x = points[:, 0] * sx - cam.native_width / 2.0
    y = points[:, 1] * sy - cam.native_height / 2.0
    rays = torch.stack([x, y, f.to(points.device).expand_as(x)], dim=1)
    return rays / torch.sqrt(torch.sum(rays * rays, dim=1, keepdim=True))


def aae(pred_hm: torch.Tensor, gt_points: torch.Tensor, cam: CameraConfig | None = None) -> torch.Tensor:
    """(B,) angular error in degrees between each heatmap's argmax and the
    GT gaze ``gt_points`` (B, 2), both in pred-grid pixels."""
    cam = cam or CameraConfig()
    H, W = pred_hm.shape[1], pred_hm.shape[2]
    r_pred = pixel_to_ray(heatmap_argmax(pred_hm), (H, W), cam)
    r_gt = pixel_to_ray(gt_points, (H, W), cam)
    d = r_pred - r_gt
    chord = torch.sqrt(torch.sum(d * d, dim=1))
    return torch.rad2deg(2.0 * torch.asin(torch.clamp(chord * 0.5, 0.0, 1.0)))


def auc_judd(pred_hm: torch.Tensor, gt_points: torch.Tensor) -> torch.Tensor:
    """(B,) Judd-style ROC AUC of each heatmap against one GT fixation:
    (pixels strictly below the GT pixel's value + half its ties) / (H·W).
    The GT pixel counts in its own tie set, so a strict maximum scores
    1 - 0.5/(H·W). The heatmap is compared in the dtype it comes in.
    The division is a multiplication by the float32 reciprocal of H·W,
    as XLA compiles the JAX version's division by a constant."""
    B, H, W = pred_hm.shape
    xi = torch.clamp(torch.round(gt_points[:, 0]).to(torch.int32), 0, W - 1)
    yi = torch.clamp(torch.round(gt_points[:, 1]).to(torch.int32), 0, H - 1)
    flat = pred_hm.reshape(B, H * W)
    gt_val = torch.gather(flat, 1, (yi * W + xi).to(torch.int64)[:, None])
    below = torch.sum(flat < gt_val, dim=1).to(torch.float32)
    ties = torch.sum(flat == gt_val, dim=1).to(torch.float32)
    return (below + 0.5 * ties) * (1.0 / float(H * W))


def compute_aae_auc(
    pred_hm: torch.Tensor, gt_points: torch.Tensor, cam: CameraConfig | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched (AAE degrees, AUC), on the heatmaps' device."""
    gt_points = torch.as_tensor(gt_points, dtype=torch.float32, device=pred_hm.device)
    return aae(pred_hm, gt_points, cam), auc_judd(pred_hm, gt_points)
