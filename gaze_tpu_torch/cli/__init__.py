"""The command line of the port: ``python -m gaze_tpu_torch.cli``.

Counterpart of ``gaze_tpu/cli.py`` (``python -m gaze_tpu.cli``), with the
same flags (``cli/args.py``) and the same order of stages:
``--extract_flow`` first, then ``--train_sp``, ``--train_qat``,
``--train_lstm``, the int8 choice (``cli/quant.py``), ``--extract_late``,
``--train_late``, ``--eval``, ``--infer``, ``--infer_batch`` and
``--export_torch`` last. A stage that needs a module nobody trained in
this invocation restores it from its checkpoint directory, and says so
loudly when there is none (it then runs from the seeded initialization).
Checkpoints are the port's own (``core/checkpoint.py``): a JAX (orbax)
checkpoint directory is not read; the JAX CLI's ``--export_torch``
bundle is the bridge (``GazePipeline.load_state_dicts``).

Everything runs on the card: ``main(argv, device=None)`` raises without
CUDA, and ``device="cpu"`` runs the plain path (the tests do). Under
torchrun with more than one rank, ``main`` joins the process group
(``core.distributed.initialize``), sizes the data mesh as the JAX CLI
does (``train/stages.py:data_parallel_mesh``, ``--dp_devices``) and
passes it to the training stages and the evaluation.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import torch

from gaze_tpu_torch.cli.args import build_argparser, make_config, stage_options
from gaze_tpu_torch.cli.evaluate import run_eval
from gaze_tpu_torch.cli.extract import run_extract_flow, run_extract_late
from gaze_tpu_torch.cli.infer import run_infer, run_infer_batch
from gaze_tpu_torch.cli.quant import eval_pipeline
from gaze_tpu_torch.core.checkpoint import restore_best_or_latest
from gaze_tpu_torch.core.distributed import initialize
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.qat import load_act_scales
from gaze_tpu_torch.models.weights_export import export_pipeline_to_torch
from gaze_tpu_torch.parallel.mesh import rank_device
from gaze_tpu_torch.train import stages
from gaze_tpu_torch.train.at import create_at_state
from gaze_tpu_torch.train.lf import create_lf_state
from gaze_tpu_torch.train.sp import create_sp_state


def _restore_trained(module: str, directory: str, state):
    """The best (else the latest) checkpoint of ``directory`` into
    ``state``, with a warning on stderr when there is none: a consumer
    stage silently scoring initialized weights is the classic
    checkpoint-directory typo."""
    state, restored = restore_best_or_latest(directory, state, report=True)
    if not restored:
        print(f"warning: no {module} checkpoint under {directory!r} — continuing from "
              f"random init (train the stage first or pass --{module}_ckpt)", file=sys.stderr)
    return state


def main(argv: Optional[List[str]] = None, *, device=None) -> None:
    args = build_argparser().parse_args(argv)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize()
    dev = rank_device(device)
    cfg = make_config(args)
    opts = stage_options(args)
    pipeline = GazePipeline(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                            device=dev, seed=cfg.train.seed, at_pool=args.at_pool,
                            decoder_impl=args.decoder)
    mesh = stages.data_parallel_mesh(args.batch_size, args.dp_devices, device=dev)
    save = args.save_dir
    sp_state = at_state = lf_state = None

    # flow extraction first: the reference's offline preprocessing, whose
    # flows/ the training stages then find (--precomputed_flow auto)
    if args.extract_flow:
        run_extract_flow(args, cfg, device=dev)
    if args.train_sp:
        sp_state = stages.run_train_sp(opts, pipeline, mesh)
    if sp_state is None and (args.train_qat or args.train_lstm or args.train_late or args.eval
                             or args.extract_late or args.export_torch or args.infer
                             or args.infer_batch or (args.quant_sp and args.quant_save)):
        _restore_trained("sp", args.sp_ckpt or os.path.join(save, "sp"),
                         create_sp_state(pipeline))
        sp_state = stages._snapshot(pipeline.sp)
    # QAT scales travel with the weights that trained against them: this
    # invocation's QAT run, or an --sp_ckpt holding one
    qat_scales = None
    if args.train_qat:
        sp_state = stages.run_train_qat(opts, pipeline, sp_state, mesh)
        qat_scales = load_act_scales(os.path.join(save, "sp_qat"))
    elif args.sp_ckpt:
        qat_scales = load_act_scales(args.sp_ckpt)
    if args.train_lstm:
        at_state = stages.run_train_lstm(opts, pipeline, sp_state, mesh)
    if at_state is None and (args.train_late or args.eval or args.extract_late
                             or args.export_torch or args.infer or args.infer_batch):
        _restore_trained("at", args.at_ckpt or os.path.join(save, "at"),
                         create_at_state(pipeline))
        at_state = stages._snapshot(pipeline.lstm)
    # the int8 pipeline shares the float one's modules: --train_late below
    # trains the float pipeline's LF head, which --eval then scores
    serving = eval_pipeline(args, cfg, pipeline, qat_scales)
    if args.extract_late:
        run_extract_late(args, cfg, serving)
    if args.train_late:
        lf_state = stages.run_train_late(opts, pipeline, sp_state, at_state, mesh)
    if lf_state is None and (args.eval or args.export_torch or args.infer or args.infer_batch):
        lf_state = _restore_trained("lf", args.lf_ckpt or os.path.join(save, "lf"),
                                    create_lf_state(pipeline))
    if args.eval:
        run_eval(args, cfg, serving, lf_state, mesh=mesh)
    if args.infer:
        run_infer(args, cfg, serving)
    if args.infer_batch:
        run_infer_batch(args, cfg, serving)
    if args.export_torch:
        export_pipeline_to_torch(pipeline, args.export_torch)
        print({"exported_torch": args.export_torch})
