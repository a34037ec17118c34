"""Golden-file parity hooks: module-boundary tensors to ``.npz`` and back.

Counterpart of ``gaze_tpu/evaluation/goldens.py``. Every module boundary
of one step (the preprocessed inputs, SP saliency and conv5, AT's pooled
weights and attention map, the LF heatmap, the gaze) can be dumped with
``save_goldens`` and compared with ``compare_goldens``, whose report is
the JAX function's: the largest absolute difference per key, ``inf`` for
a key missing on one side or a shape mismatch.

The weights are an argument of ``pipeline_module_outputs``
(``{"sp", "at", "lf"}`` state dicts), not drawn here: the committed
bundles (``tests/goldens/*.npz``) come from flax's initialization from
``jax.random.key(0)``, which the port cannot reproduce without JAX.
Bridge those variables (``models/weights.py:torch_state_from_jax``) and
pass them in to recompute a bundle.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gaze_tpu_torch.core.config import ATConfig, ImageConfig, PipelineConfig, TVL1Config
from gaze_tpu_torch.models.weights import StateDict


def save_goldens(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a named tensor bundle as compressed ``.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: _np(v) for k, v in tensors.items()})


def load_goldens(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compare_goldens(
    actual: Dict[str, np.ndarray],
    golden: Dict[str, np.ndarray],
    atol: float = 1e-5,
    rtol: float = 1e-5,
) -> Tuple[bool, Dict[str, float]]:
    """(all within ``atol``/``rtol``, per-key max abs diff). A key on one
    side only, or a shape mismatch, fails with diff ``inf``."""
    report: Dict[str, float] = {}
    ok = True
    for k in sorted(set(actual) | set(golden)):
        if k not in actual or k not in golden:
            report[k] = float("inf")
            ok = False
            continue
        a = _np(actual[k]).astype(np.float64)
        g = _np(golden[k]).astype(np.float64)
        if a.shape != g.shape:
            report[k] = float("inf")
            ok = False
            continue
        report[k] = float(np.max(np.abs(a - g))) if a.size else 0.0
        if not np.allclose(a, g, atol=atol, rtol=rtol):
            ok = False
    return ok, report


def golden_tiny_parity_config() -> PipelineConfig:
    """The 32² parity config of the pinned tiny bundle (a small TV-L1)."""
    return PipelineConfig(
        image=ImageConfig(height=32, width=32, heatmap_sigma=4.0),
        tvl1=TVL1Config(pyramid_levels=2, warps=2, iters=5),
        at=ATConfig(feature_stride=16, roi_size=1),
    )


def pipeline_module_outputs(pipeline, weights: Optional[Dict[str, StateDict]], state,
                            prev_u8, cur_u8, fixation, flow_img=None) -> Dict[str, torch.Tensor]:
    """One step's module-boundary tensors, float32, as the golden bundle's
    keys. ``weights`` (``{"sp", "at", "lf"}`` state dicts) are loaded
    into the pipeline first; None keeps its own. With ``flow_img``
    (uint8 flow images) the temporal stream takes them in place of the
    TV-L1 solve."""
    from gaze_tpu_torch.models.at import fixation_pool
    from gaze_tpu_torch.ops.heatmap import heatmap_argmax

    if weights is not None:
        pipeline.load_state_dicts(weights)
    dev = pipeline.device
    prev_u8, cur_u8 = (torch.as_tensor(x, device=dev) for x in (prev_u8, cur_u8))
    if flow_img is not None:
        flow_img = torch.as_tensor(flow_img, device=dev)
    with torch.inference_mode():
        rgb_in, flow_in = pipeline.preprocess_pair(prev_u8, cur_u8, flow_img)
        sal, feat = pipeline.sp_forward(rgb_in, flow_in)
        w = fixation_pool(feat, heatmap_argmax(sal), pipeline.config.at)
        _, out = pipeline.step(state, prev_u8, cur_u8, fixation, flow_img=flow_img)
    return {
        "rgb_in": rgb_in.float(), "flow_in": flow_in.float(),
        "sp_saliency": out["saliency"], "sp_conv5": feat, "at_weights": w,
        "at_attention": out["attention"], "lf_heatmap": out["heatmap"],
        "gaze_xy": out["gaze"],
    }
