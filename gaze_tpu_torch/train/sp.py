"""SP stage training: flow solve, preprocessing, target render, forward,
focal loss, backward and AdamW in one step on the card.

Counterpart of ``gaze_tpu/train/sp.py``. The state's module is the
pipeline's SP (``pipeline.sp``), trained in place. Each microbatch runs
``preprocess_pair`` (TV-L1 through kernels K1 and K2 under
``torch.no_grad()``), renders the Gaussian targets, runs the
train-mode forward (batch-statistics BatchNorm, ``sp.remat``) and the
loss; the gradients are averaged over ``train.grad_accum`` microbatches
and the BatchNorm statistics take the last microbatch's update. Under a
data ``mesh`` each rank feeds its rows of the global batch and the step
has the global batch's semantics (``train/common.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from gaze_tpu_torch.core.distributed import all_gather_rows, local_rows
from gaze_tpu_torch.data.augment import apply_hflip, with_flip_mask
from gaze_tpu_torch.evaluation.losses import floss
from gaze_tpu_torch.evaluation.metrics import aae, auc_judd
from gaze_tpu_torch.models.at import fixation_pool
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import StateDict, init_weights, load_state
from gaze_tpu_torch.ops.heatmap import render_gaussian
from gaze_tpu_torch.train.common import (
    TrainState,
    jit_dp_step,
    make_optimizer,
    make_state,
    microbatch_value_and_grad,
    to_device,
)


def create_sp_state(pipeline: GazePipeline, seed: Optional[int] = None) -> TrainState:
    """The SP stage's state: ``pipeline.sp`` drawn anew from
    ``torch.Generator(seed)`` (default ``train.seed``), a fresh AdamW."""
    cfg = pipeline.config
    init_weights(pipeline.sp, torch.Generator().manual_seed(
        cfg.train.seed if seed is None else seed))
    return make_state(pipeline.sp, make_optimizer(cfg.train))


def saliency_loss(pipeline: GazePipeline, sal: torch.Tensor,
                  mb: Dict[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """Focal loss of a (B, H, W) saliency map against the Gaussians at
    ``mb["gaze"]``, weighted by ``mb["valid"]`` where given (the rank's
    share of the global loss under a ``mesh``)."""
    cfg = pipeline.config
    target = render_gaussian(mb["gaze"], cfg.image.height, cfg.image.width,
                             cfg.image.heatmap_sigma)
    # Untracked frames carry no supervision: masked out of the loss.
    return floss(sal, target, cfg.loss, sample_weight=mb.get("valid"), mesh=mesh)


def sp_loss(pipeline: GazePipeline, rgb_in: torch.Tensor, flow_in: torch.Tensor,
            mb: Dict[str, torch.Tensor], mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(:func:`saliency_loss`, the new BatchNorm statistics) of the
    train-mode SP forward on preprocessed inputs."""
    sal, _, stats = pipeline.sp_forward_train(rgb_in, flow_in, mesh)
    return saliency_loss(pipeline, sal, mb, mesh), stats


def make_sp_like_train_step(pipeline: GazePipeline, loss: Callable, mesh=None):
    """``step(state, batch) -> (state, {"loss"})`` around ``loss(pipeline,
    rgb_in, flow_in, microbatch, mesh) -> (loss, new BatchNorm
    statistics)``; ``batch`` holds ``prev``/``cur`` uint8 (B, H, W, 3),
    ``gaze`` (B, 2), optionally ``valid`` (B,), ``flow_img`` and, with
    ``train.augment_flip``, a ``_flip`` mask (drawn from (seed, step) when
    absent). The SP and QAT steps.

    With a ``mesh``, ``batch`` is this rank's rows of the global batch
    (``shard_batch(mesh, batch, train.grad_accum)``), the flip coin is
    the global batch's, and the loss is the global one."""
    cfg = pipeline.config
    k = cfg.train.grad_accum

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch = to_device(batch, pipeline.device)
        if cfg.train.augment_flip and "_flip" not in batch:
            batch = with_flip_mask(batch, cfg.train.seed, state.step, mesh, k)

        def loss_fn(mb):
            if cfg.train.augment_flip:
                mb = apply_hflip(mb, cfg.image.width)
            rgb_in, flow_in = pipeline.preprocess_pair(mb["prev"], mb["cur"], mb.get("flow_img"))
            return loss(pipeline, rgb_in, flow_in, mb, mesh)

        (value, new_bs), grads = microbatch_value_and_grad(
            loss_fn, state.params, batch, k, mesh)
        state.apply_gradients(grads, new_batch_stats=new_bs)
        return state, {"loss": value}

    return jit_dp_step(step, mesh)


def make_sp_train_step(pipeline: GazePipeline, mesh=None):
    """The SP stage's step (:func:`make_sp_like_train_step` of :func:`sp_loss`)."""
    return make_sp_like_train_step(pipeline, sp_loss, mesh)


def make_sp_like_eval_step(pipeline: GazePipeline, saliency: Callable, mesh=None):
    """``step(state, batch) -> {"aae", "auc"}`` (B,) of ``saliency(state,
    rgb_in, flow_in) -> (B, H, W)``, without gradients. With a ``mesh``
    each rank scores its block of the global batch's rows and the
    metrics are all-gathered: every rank returns all B."""
    cfg = pipeline.config

    @torch.no_grad()
    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        batch = to_device(local_rows(batch, mesh), pipeline.device)
        rgb_in, flow_in = pipeline.preprocess_pair(batch["prev"], batch["cur"],
                                                   batch.get("flow_img"))
        sal = saliency(state, rgb_in, flow_in)
        return {"aae": all_gather_rows(aae(sal, batch["gaze"], cfg.camera), mesh),
                "auc": all_gather_rows(auc_judd(sal, batch["gaze"]), mesh)}

    return step


def make_sp_eval_step(pipeline: GazePipeline, mesh=None):
    """AAE and AUC of the SP saliency map with the running BatchNorm
    statistics; over a data ``mesh`` as ``make_sp_like_eval_step``."""
    return make_sp_like_eval_step(pipeline, lambda state, rgb, flow: state.module(rgb, flow)[0],
                                  mesh)


def extract_fixation_weights(pipeline: GazePipeline, sp_state: StateDict):
    """AT feature extraction: ``sp_state`` loaded into ``pipeline.sp``;
    returns ``extract(batch) -> (B, C)``, the spatial conv5 features
    pooled at the GT gaze (``fixation_pool``)."""
    load_state(pipeline.sp, sp_state)

    @torch.no_grad()
    def extract(batch: Dict) -> torch.Tensor:
        batch = to_device(batch, pipeline.device)
        rgb_in, flow_in = pipeline.preprocess_pair(batch["prev"], batch["cur"],
                                                   batch.get("flow_img"))
        _, feat = pipeline.sp(rgb_in, flow_in)
        return fixation_pool(feat, batch["gaze"].to(torch.float32), pipeline.config.at)

    return extract
