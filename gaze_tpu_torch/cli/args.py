"""The command line's flags, its config and its trainer options.

Counterpart of ``gaze_tpu/cli.py:79-426``: ``build_argparser`` has every
flag of the JAX CLI with the same name, choices, default and meaning
(its help speaks of the port where the JAX help speaks of the TPU);
``make_config`` builds the port's config tree from them as the JAX CLI
builds its own; ``stage_options`` fills the trainer's ``StageOptions``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

from gaze_tpu_torch.core.config import (
    CameraConfig,
    PipelineConfig,
    dense_flow_tvl1_config,
)
from gaze_tpu_torch.train.stages import StageOptions

CLI_DOC = """gaze_tpu_torch: the gaze pipeline's stages from the command line, on
the card (PyTorch/CUDA). Stages run in the order SP -> QAT -> AT -> LF,
then extraction, evaluation, inference and export; without --data_root
the synthetic moving-dot corpus stands in for GTEA Gaze+.

    python -m gaze_tpu_torch.cli --train_sp --synthetic --epochs 1
    python -m gaze_tpu_torch.cli --train_sp --train_lstm --train_late \
        --data_root /data/gteaplus --test_subject Alice
    python -m gaze_tpu_torch.cli --eval --data_root /data/gteaplus \
        --save_dir save
"""


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=CLI_DOC, prog="gaze_tpu_torch")
    # stage toggles
    p.add_argument("--train_sp", action="store_true", help="train the SP two-stream net")
    p.add_argument("--train_qat", action="store_true",
                   help="quantization-aware fine-tune of the SP streams "
                        "through the deployed int8 grids (after/instead "
                        "of --train_sp); saves to save_dir/sp_qat with "
                        "the activation scales it trained against — "
                        "--quant_sp then uses those scales verbatim")
    p.add_argument("--train_lstm", action="store_true", help="train the AT LSTM")
    p.add_argument("--train_late", action="store_true", help="train the LF head")
    p.add_argument("--extract_late", action="store_true",
                   help="dump frozen SP saliency + AT attention maps to "
                        "<save_dir>/maps/<video>.npz (the reference's "
                        "map-extraction stage; the in-memory LF path does "
                        "not need it, but the files match the reference "
                        "workflow)")
    p.add_argument("--extract_flow", action="store_true",
                   help="offline dense_flow replacement: TV-L1 on the card "
                        "over every consecutive frame pair of "
                        "<data_root>/images/, written as 8-bit flow "
                        "images in dense_flow's layout (default "
                        "<data_root>/flows/ — which --precomputed_flow "
                        "and reference-era PyTorch workflows consume); "
                        "pair with --tvl1_preset dense_flow for the "
                        "OpenCV-matched solver schedule")
    p.add_argument("--flow_out", type=str, default=None, metavar="DIR",
                   help="--extract_flow output root (default "
                        "<data_root>/flows)")
    p.add_argument("--flow_bound", type=float, default=None,
                   help="--extract_flow quantization clip in ±pixels "
                        "(dense_flow's -b; default: the config's "
                        "tvl1.quant_bound, so produced and consumed "
                        "grids agree)")
    p.add_argument("--flow_layout", choices=["xy", "packed"], default="xy",
                   help="--extract_flow layout: flow_x_/flow_y_ "
                        "grayscale pairs (dense_flow default) or packed "
                        "(ch0=x, ch1=y) single files")
    p.add_argument("--flow_format", choices=["jpg", "png"], default="jpg",
                   help="--extract_flow image format (jpg = dense_flow "
                        "parity, lossy; png = lossless)")
    p.add_argument("--infer", type=str, default=None, metavar="PATH",
                   help="run gaze inference on a raw video file (MJPEG "
                        "AVI works with no ffmpeg; other codecs need "
                        "ffmpeg on PATH) or a directory of frames; "
                        "writes a per-frame gaze track in native pixel "
                        "coords")
    p.add_argument("--infer_batch", type=str, default=None, metavar="DIR",
                   help="batch inference: every video file (or per-video "
                        "frame directory) under DIR advances as one "
                        "stream of a single StreamServer pool — N videos "
                        "decode+predict in LOCKSTEP at multi-stream "
                        "throughput (the reference's val() processes "
                        "videos one at a time). Writes one gaze txt per "
                        "video to --infer_out (a directory here; default "
                        "<save_dir>/infer_batch/)")
    p.add_argument("--infer_out", type=str, default=None, metavar="TXT",
                   help="gaze-track output path (default "
                        "<save_dir>/infer_gaze.txt)")
    p.add_argument("--infer_heatmaps", type=str, default=None, metavar="DIR",
                   help="also dump predicted heatmap PNGs here")
    p.add_argument("--infer_heatmap_every", type=int, default=10,
                   help="dump every Nth heatmap (with --infer_heatmaps)")
    p.add_argument("--infer_overlay", type=str, default=None, metavar="AVI",
                   help="also write a gaze-overlay MJPEG AVI (predicted "
                        "heatmap blend + gaze marker on the native-res "
                        "frames — the reference's demo visualization)")
    p.add_argument("--infer_overlay_fps", type=int, default=24,
                   help="frame rate of the --infer_overlay video")
    p.add_argument("--eval", action="store_true",
                   help="evaluate the full pipeline: per-video sequential "
                        "rollout (fixsac-gated LSTM state carried across "
                        "frames, AT pooled at the SP argmax)")
    p.add_argument("--eval_map", choices=["heatmap", "saliency", "attention"],
                   default="heatmap",
                   help="which map the eval scores (rollout AND "
                        "--eval_teacher_forced): the LF fusion (default, "
                        "the reference's metric), the SP saliency alone, "
                        "or the AT attention alone — same trajectory, "
                        "per-head ablation")
    p.add_argument("--eval_teacher_forced", action="store_true",
                   help="diagnostic eval variant: stateless per-frame AT "
                        "pooled at the GT gaze (NOT the reference's "
                        "inference path; kept for ablation)")
    # data
    p.add_argument("--data_root", type=str, default=None, help="GTEA Gaze+ root")
    p.add_argument("--test_subject", type=str, default=None,
                   help="leave-one-subject-out test subject")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic moving-dot dataset")
    p.add_argument("--synthetic_blobs", type=int, default=1, metavar="K",
                   help="K > 1 switches the synthetic corpus to the "
                        "TASK-CYCLE variant: K distinct-color blobs with "
                        "no bottom-up cue for which is fixated — gaze "
                        "cycles them in a fixed color order only the AT "
                        "transition LSTM can learn (the non-vacuous "
                        "SP-vs-full ablation corpus; docs/STATUS.md)")
    p.add_argument("--synthetic_videos", type=int, default=1, metavar="V",
                   help="number of distinct synthetic training videos "
                        "(seeds 0..V-1): blob positions/backgrounds vary "
                        "per video while the task structure is shared, "
                        "so K>1 runs can't memorize one layout; eval "
                        "always uses held-out seeds 1000+")
    p.add_argument("--precomputed_flow", choices=["auto", "on", "off"],
                   default="auto",
                   help="consume dense_flow JPEGs from <root>/flows/ for "
                        "the temporal stream (strict parity with the "
                        "reference's data path) instead of solving TV-L1 "
                        "on the card; auto = use them when present")
    # optimization
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_schedule", choices=["constant", "cosine", "step"],
                   default="constant",
                   help="LR policy: constant (reference behavior), "
                        "warmup+cosine decay, or staircase step decay")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (any schedule)")
    p.add_argument("--lr_decay_steps", type=int, default=0,
                   help="cosine: total decay horizon (0 = epochs * "
                        "steps_per_epoch); step: decay interval")
    p.add_argument("--lr_decay_rate", type=float, default=0.1,
                   help="step schedule decay factor")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--lf_padding", choices=["zero", "edge"], default="zero",
                   help="LF conv border mode: zero (torch-default parity "
                        "behavior) or edge (replicate — removes the "
                        "constant-corner argmax artifact zero padding can "
                        "learn on weak-response data; see LFConfig)")
    p.add_argument("--lf_residual", action="store_true",
                   help="residual late fusion: the LF stack predicts a "
                        "logit-space correction to the SP saliency map "
                        "and its final conv starts at zero, so a fresh "
                        "head begins exactly at the saliency baseline "
                        "(LFConfig.residual; off = parity behavior)")
    p.add_argument("--remat", choices=["none", "encoders", "full"],
                   default="none",
                   help="rematerialize (torch.utils.checkpoint) training "
                        "activations: 'encoders' recomputes the two VGG "
                        "streams in the backward pass instead of storing "
                        "their activations (~3x larger per-chip batches "
                        "for ~25%% more step FLOPs); 'full' also remats "
                        "the decoder. Param trees/checkpoints are "
                        "identical across modes (SPConfig.remat)")
    p.add_argument("--augment_flip", action="store_true",
                   help="per-sample horizontal-flip augmentation in the "
                        "SP/QAT train steps (gaze mirrored; flow solved "
                        "downstream of the flip; precomputed flow images "
                        "get their x channel negated exactly)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step, scanned inside "
                        "one jit (exact mean gradient, ~K-fold less "
                        "backward memory); batch_size must divide by it")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=100,
                   help="synthetic-data steps per epoch")
    p.add_argument("--seq_len", type=int, default=16, help="AT sequence window")
    p.add_argument("--lf_rollout", type=int, default=0, metavar="T",
                   help="train LF on T-frame clip ROLLOUTS (gated LSTM, "
                        "AT pooled at SP argmax — the inference-time map "
                        "distribution) instead of teacher-forced "
                        "single-frame maps; 0 = teacher-forced (faster)")
    p.add_argument("--at_pool", choices=["sp_argmax", "prediction"],
                   default="sp_argmax",
                   help="AT pooling point at fixation onsets during "
                        "rollout (eval/serving/--lf_rollout): the "
                        "current SP argmax (default, parity path) or "
                        "the model's own previous final prediction "
                        "(self-tracking mode — the LSTM then "
                        "anticipates the CURRENT fixation; see the "
                        "task-cycle ablation in docs/STATUS.md)")
    p.add_argument("--decoder", choices=["deconv", "pixelshuffle", "halfres"],
                   default="deconv",
                   help="SP decoder tail on inference surfaces "
                        "(eval/serve/infer): canonical ConvTranspose or "
                        "the exact polyphase serving form "
                        "(models/decode_fast.py — same trained params, "
                        "4x fewer nominal MACs, BN folded on running "
                        "stats). Training always uses deconv")
    p.add_argument("--at_stateless", action="store_true",
                   help="ablation: train AT on independent zero-carry "
                        "windows instead of the default stateful TBPTT "
                        "(carry chained across a video's windows)")
    # checkpoints
    p.add_argument("--save_dir", type=str, default="save")
    for stage in ("sp", "at", "lf"):
        p.add_argument(f"--{stage}_ckpt", type=str, default=None,
                       help=f"{stage.upper()} checkpoint directory (default "
                            f"<save_dir>/{stage}) in the port's format "
                            "(<step>.pt, core/checkpoint.py); a JAX (orbax) "
                            "checkpoint directory is not read: export it "
                            "with the JAX CLI's --export_torch instead")
    p.add_argument("--pretrained_vgg", type=str, default=None,
                   help="torchvision vgg16 .pth for encoder init")
    p.add_argument("--export_torch", type=str, default=None, metavar="PATH",
                   help="export the loaded SP/AT/LF weights as a torch "
                        "state-dict bundle, the JAX CLI's file with the "
                        "same keys (models/weights_export.py)")
    # misc
    p.add_argument("--image_size", type=str, default="224",
                   help="model grid: N (square) or HxW (e.g. 288x384 for "
                        "4:3 GTEA native aspect)")
    p.add_argument("--camera", choices=["gtea_plus", "gtea"],
                   default="gtea_plus",
                   help="AAE camera geometry preset: GTEA Gaze+ (960x720) "
                        "or original GTEA Gaze (640x480) — the reference "
                        "reports both datasets")
    p.add_argument("--dp_devices", type=int, default=None,
                   help="ranks for data parallelism (default: every rank "
                        "of the torchrun job; one process per card)")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--ckpt_every", type=int, default=500,
                   help="periodic checkpoint interval in steps (0 = only "
                        "at stage end)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="periodic SP validation interval in steps (0 = off)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (f32 params) — the serving/"
                        "throughput preset; default float32 parity path")
    p.add_argument("--flow_scale", type=float, default=1.0,
                   help="solve TV-L1 at this fraction of the model grid "
                        "and upsample (1.0 = parity path; 0.5 = the "
                        "production preset's 4x-cheaper solve)")
    p.add_argument("--tvl1_warps", type=int, default=None,
                   help="override TV-L1 warps per pyramid level "
                        "(default per TVL1Config)")
    p.add_argument("--tvl1_iters", type=int, default=None,
                   help="override TV-L1 primal-dual iterations per warp")
    p.add_argument("--tvl1_preset", choices=["ipol", "dense_flow"],
                   default="ipol",
                   help="solver schedule: ipol (Sanchez et al. defaults) "
                        "or dense_flow (OpenCV DualTVL1 defaults — scale "
                        "step 0.8, medianBlur 5, 5x30 iterations — to "
                        "approximate the reference's actual flow when "
                        "flows/ is absent; ~3x solver cost)")
    p.add_argument("--quant_sp", action="store_true",
                   help="int8-quantize the SP VGG streams for eval/"
                        "extraction (PTQ calibrated on a few training "
                        "batches; models/quant.py). Serving-path knob — "
                        "training stages ignore it")
    p.add_argument("--quant_percentile", type=float, default=None,
                   help="calibrate activation scales at this upper "
                        "percentile of |x| (e.g. 99.9) instead of the "
                        "max — robust to outlier pixels on real data")
    p.add_argument("--quant_calib_batches", type=int, default=8,
                   help="training batches used for PTQ calibration")
    p.add_argument("--quant_conv", choices=["xla", "pallas"], default="xla",
                   help="the JAX package's int8 conv choice under --quant_sp, "
                        "kept for its command lines: both run the 3x3 int8 "
                        "convs through the hand-written Hopper kernel "
                        "(csrc/conv_int8.cu) on the card and its plain "
                        "version on the CPU")
    p.add_argument("--quant_stem", choices=["int8", "bf16"], default="int8",
                   help="conv1_1 precision under --quant_sp: bf16 runs "
                        "the depth-27 stem off the unquantized input "
                        "(models/quant.py); int8 (default) keeps the "
                        "fully-quantized chain; QAT-scale checkpoints "
                        "always use int8 (the twin they trained against)")
    p.add_argument("--quant_save", type=str, default=None, metavar="NPZ",
                   help="after PTQ/QAT quantization, write the calibrated "
                        "int8 bundle (kernels + scales + col sums, "
                        "models/quant_io.py) — the deployment artifact a "
                        "serving host loads instead of recalibrating")
    p.add_argument("--quant_load", type=str, default=None, metavar="NPZ",
                   help="serve from a saved int8 bundle (implies "
                        "--quant_sp; skips calibration — no training "
                        "data or f32 weights needed for the SP streams)")
    p.add_argument("--tboard", default=None, metavar="DIR",
                   help="also mirror step metrics into TensorBoard event "
                        "files under DIR/<stage>/ (dependency-free "
                        "writer, utils/tboard.py)")
    p.add_argument("--debug_nans", action="store_true",
                   help="the counterpart of the JAX CLI's jax_debug_nans: "
                        "torch.autograd.set_detect_anomaly(True), which "
                        "raises when a backward pass (the training steps) "
                        "produces NaN and names the forward op that made "
                        "it; it does not check forward-only paths (eval, "
                        "inference, extraction) or NaNs that stay in the "
                        "forward outputs")
    return p


def parse_image_size(spec: str) -> Tuple[int, int]:
    """'224' -> (224, 224); '288x384' -> (288, 384) as (height, width)."""
    if "x" in spec:
        h, w = spec.lower().split("x", 1)
        return int(h), int(w)
    n = int(spec)
    return n, n


def make_config(args) -> PipelineConfig:
    """The config tree of the flags (``gaze_tpu/cli.py:366-426``): the
    default config with the model grid, the camera, the TV-L1 schedule,
    remat, the LF head's options and the training settings replaced. A
    cosine schedule with no ``--lr_decay_steps`` decays over the whole
    run (epochs x steps_per_epoch)."""
    base = PipelineConfig()
    ih, iw = parse_image_size(args.image_size)
    cam = CameraConfig.gtea_gaze() if args.camera == "gtea" else CameraConfig.gtea_gaze_plus()
    tvl1 = dense_flow_tvl1_config() if args.tvl1_preset == "dense_flow" else base.tvl1
    tvl1 = dataclasses.replace(
        tvl1, flow_scale=args.flow_scale,
        **{k: v for k, v in (("warps", args.tvl1_warps), ("iters", args.tvl1_iters))
           if v is not None})
    decay = args.lr_decay_steps or (
        args.epochs * args.steps_per_epoch if args.lr_schedule == "cosine" else 0)
    return dataclasses.replace(
        base,
        image=dataclasses.replace(base.image, height=ih, width=iw),
        camera=cam,
        tvl1=tvl1,
        sp=dataclasses.replace(base.sp, remat=args.remat),
        lf=dataclasses.replace(base.lf, padding=args.lf_padding, residual=args.lf_residual),
        train=dataclasses.replace(
            base.train,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            epochs=args.epochs,
            lr_schedule=args.lr_schedule,
            warmup_steps=args.warmup_steps,
            lr_decay_steps=decay,
            lr_decay_rate=args.lr_decay_rate,
            grad_clip_norm=args.grad_clip,
            grad_accum=args.grad_accum,
            augment_flip=args.augment_flip,
        ),
    )


def stage_options(args) -> StageOptions:
    """The trainer's options (``train/stages.py:StageOptions``) from the
    flags of the same names."""
    return StageOptions(**{f.name: getattr(args, f.name)
                           for f in dataclasses.fields(StageOptions)})
