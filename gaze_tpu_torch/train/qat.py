"""The QAT fine-tuning stage of the SP streams (``models/qat.py``).

Counterpart of ``gaze_tpu/train/qat.py``. It sits between the SP stage and
the int8 serving path: from the trained SP, the deployment activation
grids are calibrated once (:func:`calibrate_qat_scales`), then the SP
trains with both VGG streams through the fake-quant forward while the
fuse/decoder tail trains as usual in the pipeline's dtype. The step is
the SP step's (``train/sp.py:make_sp_like_train_step``: flip,
``preprocess_pair`` with K1 and K2 under ``no_grad``, Gaussian targets,
``floss``, microbatches, AdamW) with the saliency of
``_fake_quant_saliency``. No kernel runs in the fake-quant forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.qat import qat_vgg_forward
from gaze_tpu_torch.models.quant import calibrate_vgg, preprocessed_batches
from gaze_tpu_torch.train.sp import (
    make_sp_like_eval_step,
    make_sp_like_train_step,
    saliency_loss,
)

Scales = Dict[str, Dict[str, torch.Tensor]]


def _on_device(act_scales: Scales, device) -> Scales:
    """The scales on ``device`` as ordinary tensors (``calibrate_vgg``
    returns inference tensors, which autograd may not save)."""
    return {stream: {k: v.to(device).clone() for k, v in d.items()}
            for stream, d in act_scales.items()}


def calibrate_qat_scales(pipeline: GazePipeline, frame_pairs,
                         percentile: Optional[float] = None) -> Scales:
    """Per-stream activation grids of ``pipeline.sp`` from raw uint8 frame
    pairs through the pipeline's own preprocessing: the bounds
    deployment's PTQ calibration computes (``calibrate_vgg``)."""
    if not frame_pairs:
        raise ValueError("QAT calibration needs at least one frame pair")
    rgb_b, flow_b = preprocessed_batches(pipeline, frame_pairs)
    sp = pipeline.sp
    scales = {"spatial": calibrate_vgg(sp.spatial, rgb_b, percentile=percentile),
              "temporal": calibrate_vgg(sp.temporal, flow_b, percentile=percentile)}
    return _on_device(scales, pipeline.device)


def _fake_quant_saliency(pipeline: GazePipeline, act_scales: Scales, rgb_in: torch.Tensor,
                         flow_in: torch.Tensor, train: bool, mesh=None
                         ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Saliency through the fake-quant streams and the float tail:
    (saliency, the new BatchNorm statistics in train mode, else None).
    With ``sp.remat`` other than "none" each stream runs under
    ``checkpoint`` ("full" checkpoints the decoder too, as
    ``SPNet.fuse_decode_train`` does)."""
    sp = pipeline.sp

    def stream(vgg, scales, x):
        if sp.cfg.remat != "none":
            return checkpoint(qat_vgg_forward, vgg, scales, x, use_reentrant=False)
        return qat_vgg_forward(vgg, scales, x)

    fs = stream(sp.spatial, act_scales["spatial"], rgb_in).to(pipeline.dtype)
    ft = stream(sp.temporal, act_scales["temporal"], flow_in).to(pipeline.dtype)
    if train:
        return sp.fuse_decode_train(fs, ft, mesh)
    return sp.fuse_decode(fs, ft), None


def qat_loss(pipeline: GazePipeline, act_scales: Scales, rgb_in: torch.Tensor,
             flow_in: torch.Tensor, mb: Dict[str, torch.Tensor], mesh=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(focal loss, the new BatchNorm statistics) of the train-mode
    fake-quant saliency on preprocessed inputs (``train/sp.py:sp_loss``'s
    counterpart; global under a data ``mesh``)."""
    sal, stats = _fake_quant_saliency(pipeline, act_scales, rgb_in, flow_in, train=True,
                                      mesh=mesh)
    return saliency_loss(pipeline, sal, mb, mesh), stats


def make_qat_train_step(pipeline: GazePipeline, act_scales: Scales, mesh=None):
    """The QAT step: ``make_sp_train_step``'s contract with :func:`qat_loss`;
    the state is the SP stage's (``create_sp_state``)."""
    scales = _on_device(act_scales, pipeline.device)
    return make_sp_like_train_step(
        pipeline, lambda p, rgb_in, flow_in, mb, m: qat_loss(p, scales, rgb_in, flow_in, mb, m),
        mesh)


def make_qat_eval_step(pipeline: GazePipeline, act_scales: Scales):
    """AAE and AUC of the fake-quant saliency with the running BatchNorm
    statistics: the metric QAT's best checkpoint tracks."""
    scales = _on_device(act_scales, pipeline.device)
    return make_sp_like_eval_step(
        pipeline, lambda state, rgb, flow: _fake_quant_saliency(pipeline, scales, rgb, flow,
                                                                train=False)[0])
