"""The int8 choice of the command line's consumer stages.

Counterpart of ``gaze_tpu/cli.py:1333-1397``. ``--quant_load`` serves a
saved int8 bundle; ``--quant_sp`` quantizes the SP streams, with the QAT
scales when the SP weights came from a QAT run (this invocation's
``--train_qat``, or an ``--sp_ckpt`` holding ``qat_act_scales.npz``), else
by PTQ calibration on ``--quant_calib_batches`` training batches;
``--quant_save`` writes the bundle.

The JAX CLI makes a second pipeline object for the int8 path
(``dataclasses.replace``), so training in the same invocation keeps the
full-precision one. The port's int8 pipeline is
``GazePipeline.with_quant``: it shares the float pipeline's modules, so
``--train_late`` after ``--extract_late`` trains the float pipeline's LF
head through the float streams, and ``--eval`` then scores that head
behind the int8 streams, as the JAX CLI does.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

from gaze_tpu_torch.cli.args import stage_options
from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.quant import QuantSP, build_quant_vgg, calibrate_pipeline_sp
from gaze_tpu_torch.models.quant_io import load_quant_sp, save_quant_sp
from gaze_tpu_torch.train.stages import _calibration_pairs


def quant_from_qat_scales(pipeline: GazePipeline, scales: Dict) -> QuantSP:
    """The int8 streams of the pipeline's SP on the grids QAT trained
    against (the full int8 chain, no bf16 stem)."""
    with torch.no_grad():
        return QuantSP(spatial=build_quant_vgg(pipeline.sp.spatial, scales["spatial"]),
                       temporal=build_quant_vgg(pipeline.sp.temporal, scales["temporal"]))


def eval_pipeline(args, cfg: PipelineConfig, pipeline: GazePipeline,
                  qat_scales: Optional[Dict]) -> GazePipeline:
    """The pipeline the consumer stages run: ``pipeline`` itself, or an
    int8 pipeline sharing its modules."""
    consumers = args.eval or args.extract_late or args.infer or args.infer_batch
    if args.quant_load and consumers:
        qsp = load_quant_sp(args.quant_load)
        print({"quant_sp": "int8", "bundle": args.quant_load})
        if args.quant_save:
            print("--quant_save ignored under --quant_load (the bundle already exists)",
                  file=sys.stderr)
        return pipeline.with_quant(qsp, args.quant_conv)
    if not (args.quant_sp and (consumers or args.quant_save)):
        return pipeline
    if qat_scales is not None:
        qsp = quant_from_qat_scales(pipeline, qat_scales)
        if args.quant_stem == "bf16":
            print("--quant_stem bf16 ignored: QAT scales quantize through the exact "
                  "chain the weights were fine-tuned against (full int8)", file=sys.stderr)
        print({"quant_sp": "int8", "scales": "qat"})
    else:
        pairs = _calibration_pairs(stage_options(args), cfg)
        if not pairs:
            raise ValueError("--quant_sp: no training batches available for PTQ "
                             "calibration (empty training split?)")
        qsp = calibrate_pipeline_sp(pipeline, pairs, percentile=args.quant_percentile,
                                    bf16_stem=args.quant_stem == "bf16")
        print({"quant_sp": "int8", "calibration_batches": len(pairs),
               "percentile": args.quant_percentile, "stem": args.quant_stem})
    if args.quant_save:
        save_quant_sp(args.quant_save, qsp)
        print({"quant_bundle_saved": args.quant_save})
    return pipeline.with_quant(qsp, args.quant_conv)
