"""Quantization-aware training (QAT) of the SP VGG streams: the fake-quant
forward.

Counterpart of ``gaze_tpu/models/qat.py``. The forward mirrors the
deployed int8 chain (``models/quant.py:quant_vgg_forward``) op for op in
float32, so the weights fine-tune through the grids deployment uses:

- weights: per-output-channel symmetric int8, scale max|w| / 127,
  recomputed from the live weights every step (OIHW here: the max over
  dims 1-3);
- activations: fixed calibrated per-layer scales (``calibrate_vgg``'s);
  conv1_1's input on the signed [-127, 127] grid, every interior
  activation on the unsigned [0, 255] grid, whose lower clip is the ReLU;
- max-pools run on the fake-quantized values; conv5_3 ends in a plain
  ReLU.

Gradients follow the clipped straight-through estimator with the JAX
package's arithmetic: the forward value is ``x_c + (q - x_c)`` with the
difference detached, and ``x_c`` is ``jnp.clip``'s ``minimum(maximum(x,
lo), hi)``, whose gradient halves where x lies exactly on a bound (the
largest weight of almost every output channel does: ``(max|w| / 127) *
127 == max|w|`` in float32), where ``torch.clamp`` would pass all of it.
The scales take no gradient.

Deployment takes a QAT checkpoint through the PTQ path: ``build_quant_vgg``
with the scales saved beside it (:func:`save_act_scales`, the JAX
package's file name and keys, so either package reads the other's).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaze_tpu_torch.models.quant import LAYERS
from gaze_tpu_torch.models.vgg import VGG16Features

Tensors = Dict[str, torch.Tensor]
SCALES_FILE = "qat_act_scales.npz"


def _ste_fake_quant(x: torch.Tensor, scale: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``scale * clip(round(x / scale), lo, hi)`` with the clipped
    straight-through gradient: 1 inside the representable range, 1/2 on
    its bounds, 0 outside."""
    s = scale.detach()
    with torch.no_grad():
        q = torch.clamp(torch.round(x / s), lo, hi) * s
    x_c = torch.minimum(torch.maximum(x, lo * s), hi * s)
    return x_c + (q - x_c).detach()


def fake_quant_kernel(k: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake quant of an OIHW kernel,
    scales from the live weights."""
    s = torch.clamp_min(k.detach().abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, 1e-12)
    return _ste_fake_quant(k, s, -127, 127)


def qat_vgg_forward(vgg: VGG16Features, act_scales: Tensors, x: torch.Tensor) -> torch.Tensor:
    """Differentiable twin of ``quant_vgg_forward``: NHWC input (any float
    dtype) -> float32 NHWC conv5 features, every activation on its
    deployed grid."""
    x = _ste_fake_quant(x.float().permute(0, 3, 1, 2), act_scales[LAYERS[0]], -127, 127)
    li = 0
    for s, stage in enumerate(vgg.stages):
        for _ in stage:
            conv = getattr(vgg, LAYERS[li])
            li += 1
            k = fake_quant_kernel(conv.weight.float())
            y = F.conv2d(x, k, padding=1) + conv.bias.float()[:, None, None]
            if li < len(LAYERS):
                x = _ste_fake_quant(y, act_scales[LAYERS[li]], 0, 255)
            else:
                x = F.relu(y)
        if s < len(vgg.stages) - 1:
            x = F.max_pool2d(x, 2, 2)
    return x.permute(0, 2, 3, 1)


def save_act_scales(ckpt_dir: str, scales: Dict[str, Tensors]) -> str:
    """Write the scales QAT trained against to ``<ckpt_dir>/qat_act_scales.npz``
    (keys ``<stream>/<layer>``, float32), so deployment quantizes with the
    same grids. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, SCALES_FILE)
    flat = {f"{stream}/{layer}": np.asarray(v.detach().cpu().numpy(), np.float32)
            for stream, d in scales.items() for layer, v in d.items()}
    np.savez(path, **flat)
    return path


def load_act_scales(ckpt_dir: str) -> Optional[Dict[str, Tensors]]:
    """The scales of ``<ckpt_dir>/qat_act_scales.npz`` on the CPU; None when
    there is no such file."""
    path = os.path.join(ckpt_dir, SCALES_FILE)
    if not os.path.exists(path):
        return None
    out: Dict[str, Tensors] = {}
    with np.load(path) as z:
        for key in z.files:
            stream, layer = key.split("/", 1)
            out.setdefault(stream, {})[layer] = torch.from_numpy(np.array(z[key]))
    return out
