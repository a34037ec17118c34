"""The program under test, reached only through its public entry points:
``core/config.py`` (``PipelineConfig`` and its parts), ``GazePipeline``
and ``run_clip``, ``StreamServer``, ``models/quant.py:
calibrate_pipeline_sp``, ``train/sp.py:make_sp_train_step`` with
``train/common.py``'s state and optimizer, and the launch counters of
its kernels."""

from __future__ import annotations

import dataclasses

import torch


def pipeline_config(cfg: dict):
    """The configuration file as the program's ``PipelineConfig``."""
    from gaze_tpu_torch.core import config as c

    im, tv, sp, at, lf = cfg["image"], cfg["tvl1"], cfg["sp"], cfg["at"], cfg["lf"]
    tr = cfg["train"]
    return c.PipelineConfig(
        image=c.ImageConfig(height=im["height"], width=im["width"], mean=tuple(im["mean"]),
                            std=tuple(im["std"]), heatmap_sigma=im["heatmap_sigma"]),
        tvl1=c.TVL1Config(**tv),
        sp=c.SPConfig(flow_channels=sp["flow_channels"], fused_channels=sp["fused_channels"],
                      decoder_channels=tuple(sp["decoder_channels"]),
                      stages=tuple(tuple(s) for s in sp["stages"]), remat=tr["remat"]),
        at=c.ATConfig(**at),
        lf=c.LFConfig(channels=tuple(lf["channels"]), padding=lf["padding"]),
        loss=c.LossConfig(**cfg["loss"]),
        train=dataclasses.replace(c.TrainConfig(), learning_rate=tr["learning_rate"],
                                  weight_decay=tr["weight_decay"]),
    )


def dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["precision"]["activations"])


def pipeline(cfg: dict, weights, device, quant_sp=None):
    """A ``GazePipeline`` of the configuration holding ``weights``."""
    from gaze_tpu_torch.models.pipeline import GazePipeline

    p = GazePipeline(pipeline_config(cfg), dtype=dtype(cfg), device=device, quant_sp=quant_sp)
    p.load_state_dicts(weights)
    return p


def calibrate(cfg: dict, pipe, pairs, quant_tail: bool = False):
    """The int8 streams the configuration states, calibrated by the
    program from the uint8 frame pairs."""
    from gaze_tpu_torch.models.quant import calibrate_pipeline_sp

    q = cfg["quant"]
    return calibrate_pipeline_sp(pipe, pairs, percentile=q["percentile"],
                                 bf16_stem=q["stem"] == "bf16", quant_tail=quant_tail)


def int8_streams(cfg: dict) -> bool:
    return cfg["precision"]["vgg"] == "int8"


def served_pipeline(run, weights, calib, device):
    """The cell's pipeline: the configuration's, its int8 streams
    calibrated on ``calib``; for the ``control`` variant the lower
    precision the cell's file names (``control``): the int8 fuse/decoder
    tail (``quant_tail``), or int8 streams (``quant_sp``) in place of
    bf16 ones."""
    cfg = run.config
    pipe = pipeline(cfg, weights, device)
    ctl = run.spec.get("control", {}) if run.variant == "control" else {}
    qcfg = ctl.get("quant_sp") or (cfg.get("quant") if int8_streams(cfg) else None)
    if qcfg is None:
        return pipe
    return pipe.with_quant(calibrate({"quant": qcfg}, pipe, calib,
                                     quant_tail=bool(ctl.get("quant_tail"))))
