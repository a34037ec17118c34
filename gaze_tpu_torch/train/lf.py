"""LF stage training: the late-fusion head on frozen SP and AT maps.

Counterpart of ``gaze_tpu/train/lf.py``. The frozen SP and AT forward
(TV-L1 through kernels K1 and K2 included) and the LF update run in one
step; the maps never leave the card. The state's module is the
pipeline's LF head (``pipeline.lf``), trained in place; the frozen SP and
AT state dicts are loaded into ``pipeline.sp`` and ``pipeline.lstm``
when a step function is made. Under a data ``mesh`` each rank feeds its
rows of the global batch; the frozen maps are per sample, and the loss
is the global one (``floss``'s global weight sum).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gaze_tpu_torch.evaluation.losses import floss
from gaze_tpu_torch.evaluation.metrics import aae, auc_judd
from gaze_tpu_torch.models.at import attention_map, fixation_pool
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import StateDict, init_weights, load_state
from gaze_tpu_torch.ops.heatmap import render_gaussian
from gaze_tpu_torch.train.common import (
    TrainState,
    dp_reduce,
    jit_dp_step,
    make_optimizer,
    make_state,
    to_device,
)

SCORE_KEYS = ("heatmap", "saliency", "attention")


def create_lf_state(pipeline: GazePipeline, seed: Optional[int] = None) -> TrainState:
    """The LF stage's state: ``pipeline.lf`` drawn anew from
    ``torch.Generator(seed)`` (default ``train.seed``), a fresh AdamW."""
    cfg = pipeline.config
    init_weights(pipeline.lf, torch.Generator().manual_seed(
        cfg.train.seed if seed is None else seed))
    return make_state(pipeline.lf, make_optimizer(cfg.train))


def load_frozen(pipeline: GazePipeline, frozen: Dict[str, StateDict]) -> None:
    """``frozen["sp"]`` and ``frozen["at"]`` into the pipeline's SP and AT."""
    load_state(pipeline.sp, frozen["sp"])
    load_state(pipeline.lstm, frozen["at"])


@torch.no_grad()
def _frozen_maps(pipeline: GazePipeline, batch: Dict[str, torch.Tensor]):
    """(saliency, attention) maps (B, H, W) of the frozen SP and AT. AT
    is teacher-forced: pooled at the GT gaze, one step from a zero carry
    for every batch element."""
    cfg = pipeline.config
    rgb_in, flow_in = pipeline.preprocess_pair(batch["prev"], batch["cur"],
                                               batch.get("flow_img"))
    sal, feat = pipeline.sp_forward(rgb_in, flow_in)
    w = fixation_pool(feat, batch["gaze"].to(torch.float32), cfg.at)
    carries = pipeline.lstm.init_carry(sal.shape[0], pipeline.device)
    _, w_hat = pipeline.lstm.step(carries, w)
    amap = attention_map(feat, w_hat, (cfg.image.height, cfg.image.width))
    return sal, amap


def _lf_loss(pipeline: GazePipeline, head, sal, amap, gaze, weight, mesh) -> torch.Tensor:
    cfg = pipeline.config
    target = render_gaussian(gaze, cfg.image.height, cfg.image.width, cfg.image.heatmap_sigma)
    pred = head(torch.stack([sal, amap], dim=-1))
    return floss(pred, target, cfg.loss, sample_weight=weight, mesh=mesh)


def make_lf_train_step(pipeline: GazePipeline, frozen: Dict[str, StateDict], mesh=None):
    """Teacher-forced step on SP-style batches (``prev``, ``cur``,
    ``gaze``, optionally ``valid``, ``flow_img``)."""
    load_frozen(pipeline, frozen)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch = to_device(batch, pipeline.device)
        sal, amap = _frozen_maps(pipeline, batch)
        loss = _lf_loss(pipeline, state.module, sal, amap, batch["gaze"], batch.get("valid"),
                        mesh)
        loss, grads = dp_reduce(loss, torch.autograd.grad(loss, state.params), mesh)
        state.apply_gradients(grads)
        return state, {"loss": loss.detach()}

    return jit_dp_step(step, mesh)


def make_map_extract_step(pipeline: GazePipeline, frozen: Dict[str, StateDict]):
    """``step(batch) -> {"saliency", "attention"}``: the frozen maps of a
    batch (the map-extraction stage's content)."""
    load_frozen(pipeline, frozen)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        sal, amap = _frozen_maps(pipeline, to_device(batch, pipeline.device))
        return {"saliency": sal, "attention": amap}

    return step


def make_lf_rollout_train_step(pipeline: GazePipeline, frozen: Dict[str, StateDict], mesh=None):
    """LF trained on rolled-out attention maps: each batch element is a
    contiguous clip (``frames`` (B, T+1, H, W, 3) uint8, ``fixsac``,
    ``gaze``, ``valid`` (B, T+1, ...); the labels of frames[1:]
    supervise). The frozen pipeline runs the per-frame rollout
    (``forward_step``, with the head being trained as its LF) under
    ``torch.no_grad()``, and the head learns on the (saliency, attention)
    pairs it will fuse at inference. The state's module must be
    ``pipeline.lf``."""
    load_frozen(pipeline, frozen)
    cfg = pipeline.config

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if state.module is not pipeline.lf:
            raise ValueError("the rollout runs pipeline.lf: train that module")
        batch = to_device(batch, pipeline.device)
        frames = batch["frames"]
        B, T = frames.shape[0], frames.shape[1] - 1
        fix = batch["fixsac"].to(torch.float32)
        st = pipeline.init_state(B)
        sals, amaps = [], []
        with torch.no_grad():
            for t in range(T):
                st, out = pipeline.forward_step(st, frames[:, t], frames[:, t + 1], fix[:, t + 1])
                sals.append(out["saliency"])
                amaps.append(out["attention"])
        sal = torch.stack(sals, dim=1).reshape(B * T, *sals[0].shape[1:])
        amap = torch.stack(amaps, dim=1).reshape(B * T, *amaps[0].shape[1:])
        loss = _lf_loss(pipeline, state.module, sal, amap,
                        batch["gaze"][:, 1:].reshape(B * T, 2).to(torch.float32),
                        batch["valid"][:, 1:].reshape(B * T), mesh)
        loss, grads = dp_reduce(loss, torch.autograd.grad(loss, state.params), mesh)
        state.apply_gradients(grads)
        return state, {"loss": loss.detach()}

    return jit_dp_step(step, mesh)


def make_lf_eval_step(pipeline: GazePipeline, frozen: Dict[str, StateDict],
                      score_key: str = "heatmap"):
    """``step(state, batch) -> {"aae", "auc"}`` (B,) of the teacher-forced
    maps: the LF fusion ("heatmap"), the frozen SP saliency alone, or the
    AT attention alone."""
    if score_key not in SCORE_KEYS:
        raise ValueError(f"unknown score_key {score_key!r}")
    load_frozen(pipeline, frozen)
    cfg = pipeline.config

    @torch.no_grad()
    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        batch = to_device(batch, pipeline.device)
        sal, amap = _frozen_maps(pipeline, batch)
        if score_key == "saliency":
            pred = sal
        elif score_key == "attention":
            pred = amap
        else:
            pred = state.module(torch.stack([sal, amap], dim=-1))
        return {"aae": aae(pred, batch["gaze"], cfg.camera),
                "auc": auc_judd(pred, batch["gaze"])}

    return step
