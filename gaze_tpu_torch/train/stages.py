"""The trainer: the SP, QAT, AT and LF stages in order, on GTEA
recordings or the synthetic corpus.

Counterpart of the training stages of ``gaze_tpu/cli.py``
(``run_train_sp``, ``run_train_qat``, ``run_train_lstm``,
``run_train_late`` and their batch sources). Each stage trains one of
the pipeline's modules in place, writes periodic checkpoints to
``<save_dir>/<stage>`` (or the stage's ``*_ckpt``), validates and tracks
the best checkpoint in ``<save_dir>/<stage>_best``, and ends with the
best (else the latest) state restored into the pipeline. A run resumes
from the stage's latest checkpoint. Usage::

    from gaze_tpu_torch.core.config import parity_config
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.train.stages import (
        StageOptions, run_train_late, run_train_lstm, run_train_qat, run_train_sp)

    pipe = GazePipeline(parity_config())          # on the card
    opts = StageOptions(batch_size=8, epochs=1, steps_per_epoch=100)
    sp = run_train_sp(opts, pipe)
    sp = run_train_qat(opts, pipe, sp)            # optional: int8-aware SP
    at = run_train_lstm(opts, pipe, sp)
    lf = run_train_late(opts, pipe, sp, at)       # pipe now holds all three

With ``data_root`` the stages read a GTEA tree (``data/gtea.py``): the
videos of every subject but ``test_subject`` (default: the first
subject) train, the held-out subject's validate, and
``precomputed_flow`` says whether batches carry the tree's flow images
("auto": when every pair has one); an epoch is every training pair
(``steps_per_epoch`` counts synthetic batches only). Without it they
read the synthetic corpus. ``pretrained_vgg`` starts the SP stage's two
encoder streams from a torchvision VGG16 ``.pth`` (``models/weights_io.py``)
before a resume, and ``tboard`` mirrors every stage's logged scalars into
TensorBoard event files under ``<tboard>/<stage>/``. The command line
(``gaze_tpu_torch.cli``) fills the options from its flags.

Data-parallel training, one process per card (``core.distributed``):
every rank builds the same pipeline (the same seeds) on its card, makes
the mesh with :func:`data_parallel_mesh` (the JAX CLI's sizing) and
calls the stages with ``mesh=``. Each rank reads the same global batches
and stages its rows; rank 0 writes the checkpoints and the others wait
at a barrier; a resume and the final restore read on every rank, and
validation runs unsharded on every rank, so every rank ends with the
same weights::

    initialize()                                   # torchrun's environment
    pipe = GazePipeline(parity_config(), device=rank_device())
    mesh = data_parallel_mesh(opts.batch_size)     # None below 2 ranks
    sp = run_train_sp(opts, pipe, mesh)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gaze_tpu_torch.core.checkpoint import (
    latest_step,
    restore_best_or_latest,
    restore_checkpoint,
    save_best_checkpoint,
    save_checkpoint,
    writes,
)
from gaze_tpu_torch.core.distributed import barrier, local_rows
from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.data.gtea import FrameRecord, build_manifest, clip_batches, pair_batches
from gaze_tpu_torch.data.prefetch import device_prefetch
from gaze_tpu_torch.data.synthetic import (
    SyntheticSpec,
    batch_iterator,
    clip_iterator,
    generate_sequence,
)
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.qat import load_act_scales, save_act_scales
from gaze_tpu_torch.models.weights import StateDict, load_state
from gaze_tpu_torch.models.weights_io import init_sp_from_torch_vgg16
from gaze_tpu_torch.parallel.mesh import Mesh, make_mesh
from gaze_tpu_torch.train.at import (
    build_at_validation_windows,
    build_tbptt_schedule,
    build_weight_sequences,
    create_at_state,
    fixation_onset_weights,
    make_at_eval_step,
    make_at_stateful_eval,
    make_at_tbptt_step,
    make_at_train_step,
    split_at_validation,
)
from gaze_tpu_torch.train.common import TrainState
from gaze_tpu_torch.train.lf import (
    create_lf_state,
    make_lf_eval_step,
    make_lf_rollout_train_step,
    make_lf_train_step,
)
from gaze_tpu_torch.train.qat import (
    calibrate_qat_scales,
    make_qat_eval_step,
    make_qat_train_step,
)
from gaze_tpu_torch.train.sp import (
    create_sp_state,
    extract_fixation_weights,
    make_sp_eval_step,
    make_sp_train_step,
)
from gaze_tpu_torch.utils.logging import StepLogger


@dataclasses.dataclass(frozen=True)
class StageOptions:
    """The trainer's loop options, named and defaulted as the JAX CLI's
    flags (the optimizer's settings are ``config.train``)."""

    batch_size: int = 32
    epochs: int = 1
    steps_per_epoch: int = 100
    seq_len: int = 16             # AT window
    lf_rollout: int = 0           # > 0: LF trains on rolled-out clips of this length
    at_stateless: bool = False    # AT on independent zero-carry windows
    save_dir: str = "save"
    sp_ckpt: Optional[str] = None
    at_ckpt: Optional[str] = None
    lf_ckpt: Optional[str] = None
    log_every: int = 20
    ckpt_every: int = 500         # periodic checkpoint every N steps (0 = off)
    eval_every: int = 0           # SP validation every N steps (0 = at the end)
    synthetic_blobs: int = 1
    synthetic_videos: int = 1
    data_root: Optional[str] = None   # a GTEA tree; None = the synthetic corpus
    test_subject: Optional[str] = None   # held out of training (default: the first)
    precomputed_flow: str = "auto"    # GTEA flow images: "auto", "on" or "off"
    quant_calib_batches: int = 8      # training batches that calibrate QAT's scales
    quant_percentile: Optional[float] = None   # calibrate at this percentile of |x|, not the max
    tboard: Optional[str] = None      # mirror logged scalars into <tboard>/<stage>/ events
    pretrained_vgg: Optional[str] = None   # torchvision vgg16 .pth for the SP encoders


def data_parallel_mesh(batch_size: int, dp_devices: Optional[int] = None,
                       device=None) -> Optional[Mesh]:
    """The JAX CLI's data-parallel sizing (``gaze_tpu/cli.py:1266-1270``):
    a mesh over the largest divisor of ``batch_size`` that fits the
    ranks of the job (or ``dp_devices``), None when that is 1. Every
    process calls it; a rank beyond the mesh is refused by the stages."""
    avail = dp_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    n_dp = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    return make_mesh(n_dp, device=device) if n_dp > 1 else None


def _fit_mesh(n: int, mesh: Optional[Mesh]) -> Tuple[int, Optional[Mesh]]:
    """AT's batch or lane count on a mesh (``gaze_tpu/cli.py:731-736``,
    ``:750-755``): rounded down to a multiple of the mesh size, or no
    mesh when it is smaller than the mesh."""
    if mesh is None or n < mesh.size:
        return n, None
    return n // mesh.size * mesh.size, mesh


def _flow_mode(opts: StageOptions) -> Optional[bool]:
    """``precomputed_flow`` -> ``pair_batches``' ``use_precomputed_flow``."""
    return {"auto": None, "on": True, "off": False}[opts.precomputed_flow]


def _gtea_split(opts: StageOptions, cfg: PipelineConfig
                ) -> Tuple[List[FrameRecord], List[FrameRecord]]:
    """(train, test) records of the GTEA tree at ``data_root``, leaving
    ``test_subject`` (default: the first subject) out."""
    manifest = build_manifest(opts.data_root,
                              native_hw=(cfg.camera.native_height, cfg.camera.native_width))
    return manifest.split_leave_one_out(opts.test_subject or manifest.subjects()[0])


def _synth_spec(opts: StageOptions, cfg: PipelineConfig, seed: int,
                num_frames: Optional[int] = None) -> SyntheticSpec:
    """The synthetic corpus's spec: ``num_frames``, by default 4 batches'
    worth of frames, at least 64 (40 per blob for the task-cycle corpus)."""
    k = opts.synthetic_blobs
    if num_frames is None:
        num_frames = max(64, opts.batch_size * 4)
        if k > 1:
            num_frames = max(num_frames, 40 * k)
    return SyntheticSpec(num_frames=num_frames, height=cfg.image.height,
                         width=cfg.image.width, seed=seed, num_blobs=k)


def _batches(opts: StageOptions, cfg: PipelineConfig, train: bool) -> Iterator[Dict]:
    """SP-style batches. GTEA: the training subjects' frame pairs,
    shuffled, or the held-out subject's in order. Synthetic: validation
    is one held-out sequence (seed 1); training takes seed 0, or seeds
    2.. with several videos."""
    if opts.data_root:
        train_recs, test_recs = _gtea_split(opts, cfg)
        return pair_batches(train_recs if train else test_recs, opts.batch_size,
                            target_hw=(cfg.image.height, cfg.image.width), shuffle=train,
                            use_precomputed_flow=_flow_mode(opts))
    nv = opts.synthetic_videos if train else 1
    base = (2 if nv > 1 else 0) if train else 1
    return batch_iterator(_synth_spec(opts, cfg, base), opts.batch_size,
                          opts.steps_per_epoch, seed=base, num_videos=nv)


def _clip_batches(opts: StageOptions, cfg: PipelineConfig, clip_len: int) -> Iterator[Dict]:
    """Contiguous-clip batches for rollout-mode LF training."""
    if opts.data_root:
        train_recs, _ = _gtea_split(opts, cfg)
        return clip_batches(train_recs, opts.batch_size, clip_len,
                            (cfg.image.height, cfg.image.width))
    nv = opts.synthetic_videos
    base = 2 if nv > 1 else 0
    return clip_iterator(_synth_spec(opts, cfg, base), opts.batch_size, clip_len,
                         opts.steps_per_epoch, seed=base, num_videos=nv)


def _val_aae(eval_fn, state: TrainState, vb: Dict) -> Dict[str, float]:
    m = eval_fn(state, vb)
    keep = np.asarray(vb["valid"]) > 0
    return {"val_aae": float(np.mean(m["aae"].cpu().numpy()[keep])),
            "val_auc": float(np.mean(m["auc"].cpu().numpy()[keep]))}


def _snapshot(module: torch.nn.Module) -> StateDict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _run_sp_like_stage(opts: StageOptions, pipeline: GazePipeline, state: TrainState,
                       ckpt_dir: str, step_fn, eval_fn, stage: str,
                       mesh: Optional[Mesh]) -> StateDict:
    """The loop the SP and QAT stages share: prefetched batches (this
    rank's rows under a ``mesh``) -> train step; periodic checkpoints;
    validation AAE with best tracking (every ``eval_every`` steps and at
    the end). Returns the best SP state dict, also left in
    ``pipeline.sp``."""
    cfg = pipeline.config
    logger = StepLogger(stage, every=opts.log_every, tboard_dir=opts.tboard)

    def validate_and_track() -> None:
        val = _val_aae(eval_fn, state, next(iter(_batches(opts, cfg, train=False))))
        logger.log(state.step, val, force=True)
        save_best_checkpoint(ckpt_dir, state.step, state, val["val_aae"], mesh)

    for _ in range(opts.epochs):
        for batch in device_prefetch(_batches(opts, cfg, train=True), pipeline.device,
                                     mesh=mesh, num_microbatches=cfg.train.grad_accum):
            state, metrics = step_fn(state, batch)
            logger.log(state.step, metrics)
            if opts.ckpt_every and state.step % opts.ckpt_every == 0:
                save_checkpoint(ckpt_dir, state.step, state, mesh)
            if opts.eval_every and state.step % opts.eval_every == 0:
                validate_and_track()
    validate_and_track()   # the stage-end validation: a best always exists
    save_checkpoint(ckpt_dir, state.step, state, mesh)
    restore_best_or_latest(ckpt_dir, state)
    return _snapshot(pipeline.sp)


def run_train_sp(opts: StageOptions, pipeline: GazePipeline,
                 mesh: Optional[Mesh] = None) -> StateDict:
    """SP stage (``_run_sp_like_stage``) from fresh weights (the encoder
    streams from ``pretrained_vgg`` when given), or resumed from
    ``<save_dir>/sp``'s latest checkpoint; data-parallel over ``mesh``."""
    state = create_sp_state(pipeline)
    if opts.pretrained_vgg:
        init_sp_from_torch_vgg16(pipeline.sp, opts.pretrained_vgg,
                                 pipeline.config.sp.flow_channels)
    ckpt_dir = opts.sp_ckpt or os.path.join(opts.save_dir, "sp")
    restore_checkpoint(ckpt_dir, state)
    return _run_sp_like_stage(opts, pipeline, state, ckpt_dir,
                              make_sp_train_step(pipeline, mesh),
                              make_sp_eval_step(pipeline), "sp", mesh)


def _calibration_pairs(opts: StageOptions, cfg: PipelineConfig) -> List[tuple]:
    """The first ``quant_calib_batches`` training batches as (prev, cur,
    flow_img or None) frame pairs, for activation-scale calibration."""
    pairs = []
    for batch in _batches(opts, cfg, train=True):
        pairs.append((batch["prev"], batch["cur"], batch.get("flow_img")))
        if len(pairs) >= opts.quant_calib_batches:
            break
    return pairs


def run_train_qat(opts: StageOptions, pipeline: GazePipeline,
                  sp_state: StateDict, mesh: Optional[Mesh] = None) -> StateDict:
    """QAT stage: fine-tune the SP streams through the deployment int8
    grids (``train/qat.py``), from the trained ``sp_state``, checkpoints
    in ``<save_dir>/sp_qat`` (and ``sp_qat_best``) with the scales file
    ``qat_act_scales.npz`` beside them. A fresh start calibrates the
    scales once, from the first ``quant_calib_batches`` training batches
    (at ``quant_percentile``), and saves them; a resumed run restores the
    latest checkpoint and keeps the saved scales, the grids its weights
    adapted to (the JAX CLI calibrates again from the fine-tuned weights
    and overwrites the file). Returns the best state dict, also left in
    ``pipeline.sp``. Under a ``mesh`` every rank calibrates the same
    scales and rank 0 writes them."""
    cfg = pipeline.config
    state = create_sp_state(pipeline)
    load_state(pipeline.sp, sp_state)
    ckpt_dir = os.path.join(opts.save_dir, "sp_qat")
    restore_checkpoint(ckpt_dir, state)
    scales = load_act_scales(ckpt_dir) if latest_step(ckpt_dir) is not None else None
    if scales is None:
        pairs = _calibration_pairs(opts, cfg)
        if not pairs:
            raise ValueError("QAT: no training batches for activation-scale calibration")
        scales = calibrate_qat_scales(pipeline, pairs, percentile=opts.quant_percentile)
        if writes(mesh):
            save_act_scales(ckpt_dir, scales)
        barrier(mesh)
    return _run_sp_like_stage(opts, pipeline, state, ckpt_dir,
                              make_qat_train_step(pipeline, scales, mesh),
                              make_qat_eval_step(pipeline, scales), "qat", mesh)


def _extract_video_weights(opts: StageOptions, pipeline: GazePipeline,
                           sp_state: StateDict) -> List[np.ndarray]:
    """Per-video fixation-onset weight sequences from the frozen SP, over
    the videos the SP stage trained on."""
    cfg = pipeline.config
    extract = extract_fixation_weights(pipeline, sp_state)
    video_w = []
    if opts.data_root:
        train_recs, _ = _gtea_split(opts, cfg)
        for v in sorted({r.video for r in train_recs}):
            ws, fx = [], []
            for batch in pair_batches([r for r in train_recs if r.video == v], opts.batch_size,
                                      (cfg.image.height, cfg.image.width), shuffle=False,
                                      drop_remainder=False,
                                      use_precomputed_flow=_flow_mode(opts)):
                ws.append(extract(batch).cpu().numpy())
                # an untracked frame pools features at a garbage point: it
                # seeds no fixation weight
                fx.append(batch["fixsac"] * batch["valid"])
            if ws:
                video_w.append(fixation_onset_weights(np.concatenate(ws), np.concatenate(fx)))
        return video_w
    nv = opts.synthetic_videos
    base = 2 if nv > 1 else 0
    for v in range(nv):
        frames, gaze, fixsac = generate_sequence(_synth_spec(opts, cfg, base + v))
        ws = []
        for s in range(1, len(frames), opts.batch_size):
            idx = np.arange(s, min(s + opts.batch_size, len(frames)))
            batch = {"prev": frames[idx - 1], "cur": frames[idx], "gaze": gaze[idx]}
            ws.append(extract(batch).cpu().numpy())
        video_w.append(fixation_onset_weights(np.concatenate(ws), fixsac[1:]))
    return video_w


def run_train_lstm(opts: StageOptions, pipeline: GazePipeline,
                   sp_state: StateDict, mesh: Optional[Mesh] = None) -> StateDict:
    """AT stage: fixation weight sequences extracted with the frozen SP,
    then the LSTM trained on stateful TBPTT windows (default) or on
    independent zero-carry windows (``at_stateless``), validated on
    held-out fixations with the matching statefulness each epoch. Returns
    the best AT state dict, also left in ``pipeline.lstm``.

    Under a ``mesh`` every rank extracts every sequence; the window batch
    or the lane count is rounded down to a multiple of the mesh size and
    each rank trains on its rows (lanes and their carries), or, when
    there are fewer than the mesh's ranks, every rank trains on all of
    them unsharded, as the JAX CLI drops the mesh there."""
    cfg = pipeline.config
    video_w = [w for w in _extract_video_weights(opts, pipeline, sp_state) if len(w) >= 2]
    if not video_w:
        raise RuntimeError("no fixation sequences extracted: check the fixsac labels")
    video_w, val_w = split_at_validation(video_w)
    if opts.at_stateless:
        val_seqs, val_mask = build_at_validation_windows(val_w, opts.seq_len)
        eval_fn = make_at_eval_step(pipeline)

        def val_metric(lstm) -> Optional[float]:
            return float(eval_fn(lstm, val_seqs, val_mask)) if len(val_seqs) else None
    else:
        val_schedule = build_tbptt_schedule(
            val_w, opts.seq_len, max(1, min(opts.batch_size, len(val_w))))
        stateful_eval = make_at_stateful_eval(pipeline)

        def val_metric(lstm) -> Optional[float]:
            return stateful_eval(lstm, val_schedule) if val_schedule else None

    state = create_at_state(pipeline)
    ckpt_dir = opts.at_ckpt or os.path.join(opts.save_dir, "at")
    restore_checkpoint(ckpt_dir, state)
    logger = StepLogger("at", every=opts.log_every, tboard_dir=opts.tboard)

    def validate_and_track() -> None:
        val_mse = val_metric(state.module)
        if val_mse is None:
            return
        logger.log(state.step, {"val_mse": val_mse}, force=True)
        save_best_checkpoint(ckpt_dir, state.step, state, val_mse, mesh)

    if opts.at_stateless:
        seqs, masks = [], []
        for w in video_w:
            s, m = build_weight_sequences(w, np.ones((len(w),), np.float32), opts.seq_len,
                                          per_fixation=False)
            if len(s):
                seqs.append(s)
                masks.append(m)
        seqs, masks = np.concatenate(seqs), np.concatenate(masks)
        bs, at_mesh = _fit_mesh(min(opts.batch_size, len(seqs)), mesh)
        step_fn = make_at_train_step(pipeline, at_mesh)
        rng = np.random.default_rng(0)
        for _ in range(opts.epochs):
            order = rng.permutation(len(seqs))
            for s in range(0, len(order) - bs + 1, bs):
                idx = order[s:s + bs]
                state, metrics = step_fn(
                    state, local_rows({"weights": seqs[idx], "mask": masks[idx]}, at_mesh))
                logger.log(state.step, metrics)
            validate_and_track()
    else:
        lanes, at_mesh = _fit_mesh(max(1, min(opts.batch_size, len(video_w))), mesh)
        schedule = build_tbptt_schedule(video_w, opts.seq_len, lanes)
        step_fn = make_at_tbptt_step(pipeline, at_mesh)
        shape = (lanes // (at_mesh.size if at_mesh else 1), cfg.at.num_layers,
                 cfg.at.hidden_size)
        for _ in range(opts.epochs):
            carry_c = torch.zeros(shape, device=pipeline.device)
            carry_h = torch.zeros(shape, device=pipeline.device)
            for sched in schedule:
                batch = dict(local_rows(sched, at_mesh), carry_c=carry_c, carry_h=carry_h)
                state, metrics = step_fn(state, batch)
                carry_c, carry_h = metrics["carry_c"], metrics["carry_h"]
                logger.log(state.step, {"loss": metrics["loss"]})
            validate_and_track()

    save_checkpoint(ckpt_dir, state.step, state, mesh)
    restore_best_or_latest(ckpt_dir, state)
    return _snapshot(pipeline.lstm)


def run_train_late(opts: StageOptions, pipeline: GazePipeline, sp_state: StateDict,
                   at_state: StateDict, mesh: Optional[Mesh] = None) -> TrainState:
    """LF stage on the frozen SP and AT: teacher-forced batches, or
    rolled-out clips of ``lf_rollout`` frames (this rank's rows under a
    ``mesh``); the teacher-forced AAE of a held-out batch tracks the best
    each epoch. Returns the LF state with the best (else the latest)
    checkpoint restored into ``pipeline.lf``."""
    cfg = pipeline.config
    frozen = {"sp": sp_state, "at": at_state}
    state = create_lf_state(pipeline)
    ckpt_dir = opts.lf_ckpt or os.path.join(opts.save_dir, "lf")
    restore_checkpoint(ckpt_dir, state)
    if opts.lf_rollout > 0:
        step_fn = make_lf_rollout_train_step(pipeline, frozen, mesh)
        batches = lambda: _clip_batches(opts, cfg, opts.lf_rollout)  # noqa: E731
    else:
        step_fn = make_lf_train_step(pipeline, frozen, mesh)
        batches = lambda: _batches(opts, cfg, train=True)  # noqa: E731
    eval_fn = make_lf_eval_step(pipeline, frozen)
    logger = StepLogger("lf", every=opts.log_every, tboard_dir=opts.tboard)
    for _ in range(opts.epochs):
        for batch in device_prefetch(batches(), pipeline.device, mesh=mesh):
            state, metrics = step_fn(state, batch)
            logger.log(state.step, metrics)
        val = _val_aae(eval_fn, state, next(iter(_batches(opts, cfg, train=False))))
        logger.log(state.step, {"val_aae": val["val_aae"]}, force=True)
        save_best_checkpoint(ckpt_dir, state.step, state, val["val_aae"], mesh)
    save_checkpoint(ckpt_dir, state.step, state, mesh)
    return restore_best_or_latest(ckpt_dir, state)
