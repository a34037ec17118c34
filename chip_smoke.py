#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaze_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from gaze_tpu_torch/csrc with nvcc,
holds each kernel against its plain PyTorch version on the card (K1 warp,
against ``grid_sample``'s device time too; K2 primal-dual with its fused
median at every pyramid shape, 10 and 5 iterations, 0-2 median passes;
K3 int8 conv at every layer shape of the turbo path, with the fused 2x2
max-pool where a stage ends, ragged shapes and the int8 stem), checks
that TV-L1 recovers a known translation, and drives two presets at
full width (224², two VGG16 streams, 512-wide LSTM, LF 32-32-8) through
``run_clip`` for B=8 streams x T=8 frames:

- parity: float32, TV-L1 at 224² (4 levels x 5 warps x 10 iterations);
- turbo: bfloat16, TV-L1 at 112² (3 levels x 3 warps x 5 iterations),
  both VGG streams int8 (K3) after a calibration on 4 frame pairs of the
  clip at the 99.9th percentile with the bf16 stem.

Then two phases drive the serving and evaluation surface on the turbo
pipeline's weights and calibration:

- serve: a ``StreamServer`` of 16 slots with online I-DT fixations,
  driven by ``submit()`` over 24 frame batches (12 slots attached; at
  batch 8, with a submit in flight, two detached and two attached), then
  ``flush()`` and direct ticks; a second server ticked over the turbo
  clip is held against ``run_clip``'s outputs;
- rollout: ``rollout_eval_arrays`` over 8 synthetic videos of 17 frames
  (one with 3 untracked frames) at chunk lengths 8 and 16, whose sums
  must be equal, and a CPU run of one video's first 5 frames.

Then the tail phase: the turbo clip with the int8 fuse/decoder tail
(``calibrate_pipeline_sp(quant_tail=True)`` on the same 4 pairs), timed in
turns with the untailed clip; every tail layer (the 1x1 fuse at 14², the
four 2x2 polyphase convs at 15², 29², 57², 113² and the 1x1 out conv at
224², ``torch._int_mm`` on im2col matrices) on the main path's codes
bit-equal to its plain version (an exact float64 product), timed beside
its bound and the GEMM alone; the tail on the CPU from the same codes
(equal codes); the clip against a CPU run; a ``save_quant_sp`` /
``load_quant_sp`` round trip and a ``StreamServer`` on the loaded bundle
held to ``run_clip``.

Then the training stages at full width on the parity preset (f32,
TF32 off), weights from ``torch.Generator`` seeds, data from the port's
synthetic corpus:

- train_sp: ``make_sp_train_step`` at B=8, a warm-up step in which every
  K1 and K2 call is also run through its plain version (bit-equal, no
  input requiring grad), 5 timed steps (exactly 20 K1 and 20 K2 launches
  each), one profiled; a step with ``remat="encoders"`` (lower peak,
  gradients within a band of "none"'s); 3 production-preset steps (bf16,
  15 and 15 launches); and the first step at B=2 held to the CPU, (a) on
  the card's preprocessed inputs and (b) whole, flow included;
- train_at: fixation weights extracted with the trained SP over 4
  synthetic videos (20 and 20 launches per extract batch), TBPTT for 2
  epochs with stateful validation, and the carry threaded through
  consecutive windows against one rollout of the whole sequence;
- train_lf: 4 teacher-forced steps at B=8, a rollout step over 2 clips of
  4 frames, the eval step, a checkpoint round trip and the resume check
  (2 steps + save + restore + 2 steps = 4 steps, bit for bit, with cuDNN
  deterministic);
- qat: from the trained SP, the QAT scales calibrated on 4 pairs (their
  file round trip), the first step at B=2 held to the CPU (which replays
  the card's fake-quant codes, each within one code of its own), a warm-up step
  at B=8 with every K1/K2 call held to its plain version, 5 timed steps
  (exact launches), a ``remat="encoders"`` step, and the deploy check:
  ``build_quant_vgg`` on the QAT scales (int8 stem, 26 K3 launches)
  against the fake-quant conv5 of both streams (the reference's binding
  property, its tolerance taken on the deployed grid);
- stages: ``run_train_sp`` -> ``run_train_qat`` -> ``run_train_lstm`` ->
  ``run_train_late``, 1 epoch of 2 steps at B=4, into a temporary
  directory removed afterwards (``sp_qat/qat_act_scales.npz`` checked),
  then a rollout evaluation of the restored best weights.

Then the distributed phases, one process per card over
``torch.distributed``:

- dist_init: a world-1 NCCL process group (``file://`` rendezvous in a
  temporary directory) and the port's global mesh on this card;
- dp_train: 2 SP steps at B=8 from train_sp's initial state and batches
  with and without the mesh (every K1/K2 call of the mesh steps held to
  its plain version, exact launches), one TBPTT AT step from the trained
  LSTM and one teacher-forced LF step, each held to its step without a
  mesh; the mesh step's wall in turns with the plain one, its device
  busy time, the gradient all-reduce by CUDA events and its bytes;
- dp_gloo2: this script started twice as the ranks of a gloo group on
  the one card, the same 2 SP steps at a global B=8 (4 rows a rank): the
  ranks bit-equal, and within the bands of the world-1 steps;
- dist_serve: the serve phase's script on a turbo
  ``DistributedStreamServer`` of 16 slots and on a ``StreamServer`` over
  the mesh, gaze bit-equal to the serve phase's, exact launches a tick;
- dist_rollout: ``rollout_eval_arrays(mesh=)`` over the rollout phase's
  videos, sums equal to that phase's.

Then the data layer, on a GTEA tree the script writes to a temporary
directory removed at the end (8 videos x 33 frames at the native 720x960,
gaze txt with untracked rows, fixsac txt for four videos, one video
without gaze txt, one more video through an MJPEG AVI):

- dataset: the codec route (libjpeg through ``csrc/gaze_io.cpp`` where
  its headers exist, else PIL; cv2 or PIL to write), encode and decode
  ms per frame, the decoded frames against their sources (PSNR), the AVI
  demuxed back byte for byte by ``extract_dataset``;
- extract: ``extract_flow_images`` on the card under the dense_flow
  preset (5 levels at factor 0.8, 5 warps, 30 iterations, 2 median
  passes) at B=32 pairs a window, half the videos in each layout, with
  exactly 25 K1 and 25 K2 launches per window; one window again through
  the plain versions (codes equal); K2 at every pyramid level, bit-equal
  to its plain version, timed beside its bound;
- videos: ``rollout_eval_videos`` (turbo) over the tree in groups of 8,
  on TV-L1 at chunks of 8 and 16 (results equal) and on the extracted
  flow images (no K1/K2), exact launches per chunk, the decode wait per
  chunk and the device idle share, and one video's first frames against
  a CPU run;
- data_stages: the trainer with ``data_root`` at B=4, one epoch (every
  pair of the training subjects), SP with ``precomputed_flow="off"``
  (K1/K2 in every step, exact launches per step), then SP -> AT -> LF with
  "auto" (the flow images: no K1/K2 launch).

Each path runs with the launch counters set to 0 just before it and read
just after, and must have launched each of its kernels as often as its
configuration says (the server per tick). A short CPU run of each clip
and of the rollout with the same weights is compared with the card's. Every phase prints one JSON line; any failed
check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``. All inputs come from numpy seeds and
all weights from a ``torch.Generator`` seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core operations
K1_FLOPS_PER_PIXEL = 43     # coordinates, weights, 3 x 4 taps, epilogue
K2_FLOPS_PER_PIXEL_ITER = 54
K2_OPS_PER_PIXEL_MEDIAN = 76   # 19 comparators (a min and a max) x u1, u2
K2_DESIGN = "halo'd temporal tiling: iterations and median in shared memory, one launch"
K1_TOL = 1e-4               # relative to max(1, |plain|): fields, grad, rho_c
K2_TOL = 1e-4               # absolute on u (px) and the duals (|p| <= 1)
TVL1_SHIFT = (1.3, -0.7)    # known sub-pixel translation, px
TVL1_SHIFT_TOL = 0.25       # px, on the median recovered flow
# px, kernel path vs plain path on the card. Rounding differences of one
# ulp carried through 4 levels x 5 warps x 10 iterations and the medians
# reach 9e-4 px at 224^2 (port vs JAX on the CPU); the band is 5x that.
TVL1_BAND = 5e-3
CPU_HEATMAP_TOL = 1e-3      # card vs CPU, heatmaps in [0, 1]
# Gaze may differ from the CPU run only where the card's pick is a near
# tie on the CPU heatmap: within max(NEAR_TIE, 2 x the measured heatmap
# difference) of the CPU maximum.
NEAR_TIE = 1e-5
# Card vs CPU on the turbo clip, heatmaps in [0, 1]. Both run bf16
# activations, rounded at other places by cuDNN and the CPU's kernels (a
# bf16 step is 2^-8 relative), and a bf16 input that lands on the other
# side of a rounding boundary flips an int8 code downstream.
CPU_TURBO_TOL = 5e-2
B, T, SIZE = 8, 8, 224
# The int8 layers of one VGG16 stream at 224² (the bf16 stem conv1_1 is a
# cuDNN float32 conv): (name, grid, Ci, Co); conv5_3 dequantizes.
TURBO_INT8_LAYERS = (
    ("conv1_2", 224, 64, 64), ("conv2_1", 112, 64, 128), ("conv2_2", 112, 128, 128),
    ("conv3_1", 56, 128, 256), ("conv3_2", 56, 256, 256), ("conv3_3", 56, 256, 256),
    ("conv4_1", 28, 256, 512), ("conv4_2", 28, 512, 512), ("conv4_3", 28, 512, 512),
    ("conv5_1", 14, 512, 512), ("conv5_2", 14, 512, 512), ("conv5_3", 14, 512, 512),
)
# The last conv of each stage but the last: K3 fuses the 2x2 max-pool after it.
TURBO_POOLED_LAYERS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")
# The serve phase: a turbo StreamServer of 16 slots, 12 attached, driven by
# submit() over 24 frame batches; at batch 8, with a submit in flight, two
# slots are detached and two others attached. Then 8 direct ticks.
SERVE_STREAMS, SERVE_TICKS, S_ATTACHED = 16, 24, 12
SERVE_SWAP_AT, SERVE_DETACH, SERVE_ATTACH = 8, (10, 11), (12, 13)
SERVE_DIRECT_TICKS = 8
SERVE_CLIP_TOL = 1e-3       # server vs run_clip on the card, heatmaps in [0, 1]
# The rollout phase: 8 synthetic videos of 17 frames at 224^2; video 3 has
# 3 untracked frames (5, 6, 7: valid 0, gaze NaN); chunks of 8 and 16.
ROLL_V, ROLL_T, ROLL_UNTRACKED, ROLL_CHUNKS = 8, 17, (3, 5, 8), (8, 16)
ROLL_CPU_FRAMES = 5         # video 0's first frames, on the CPU too
ROLL_AAE_TOL = 1e-3         # degrees per frame, float32 ray arithmetic
ROLL_AUC_TOL = 1e-6         # per frame, float32 rounding of the score
# The training phases, at full width on the parity preset (f32, TF32 off):
# SP steps at B=8 (a warm-up with every K1/K2 call held to its plain
# version, 5 timed, one profiled); the first step at B=2 on the CPU too.
TRAIN_B, TRAIN_CPU_B, TRAIN_STEPS, TRAIN_LR = 8, 2, 5, 1e-4
# Card vs CPU on the same preprocessed inputs (cuDNN and the CPU's convs
# sum float32 products in other orders, through 13 VGG layers and the
# decoder, forward and backward): loss relative, the gradients' whole-model
# relative L2 difference (grad_compare says why not elementwise), BN
# statistics relative (|d| / (|ref| + 1e-3)). On an H100 the gradients
# came 1.137e-3 apart by default and 1.137e-3 with cuDNN deterministic
# (0.995e-3 with cuDNN off, PyTorch's own convolutions), the loss 9e-8:
# the gap is float32 summation order, not one cuDNN algorithm. The band
# is 2.2x the measured gap. Parameters after the step within 2 lr: Adam's
# first step is a sign test, and an element whose gradient lies in the
# noise moves by +-lr on either side.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_STATS_RTOL = 1e-4, 2.5e-3, 1e-4
REMAT_GRAD_RTOL = 1e-3      # remat="encoders" vs "none" on the card, relative L2
# The distributed phases: DP_STEPS SP steps at world size 1 over NCCL and
# at world size 2 over gloo (two processes on this card, each feeding 4
# of the 8 rows; NCCL refuses two ranks on one device), held to the steps
# without a mesh: the first step's applied gradient (the all-reduced one
# under a mesh) within TRAIN_GRAD_RTOL of the model's relative L2
# (grad_compare), which a gradient of the wrong sign, rows or
# denominators exceeds many times over, though Adam's first update is
# lr sign(g) whatever its scale, and its BatchNorm statistics within
# TRAIN_STATS_RTOL; every step's loss within DP_LOSS_RTOL relative;
# parameters within 2 lr per step (Adam's first step is a sign test, as
# train_sp's band says). Later steps' gradients and statistics start from
# parameters the sign test moved by +-lr wherever a gradient lies in
# float32 noise, so they are reported, not held (dp_compare). At world 1
# the mesh path takes BatchNorm's mean as an all-reduced sum over the
# count where the plain path calls torch.mean, so the two differ by
# float32 rounding. The two gloo ranks must be bit-equal.
DP_STEPS, DP_LOSS_RTOL = 2, 1e-5
DP_GLOO_RANKS, DP_GLOO_TIMEOUT = 2, 180
# AT: fixation weights of 4 synthetic videos of 97 frames (about 9
# fixations each), TBPTT windows of 8, 2 epochs.
AT_VIDEOS, AT_FRAMES, AT_SEED, AT_SEQ_LEN, AT_EPOCHS = 4, 97, 100, 8, 2
AT_THREAD_TOL = 1e-5        # threaded windows vs one rollout
# LF: 4 teacher-forced steps at B=8, one rollout step over 2 clips of 4.
LF_STEPS, LF_CLIPS, LF_T = 4, 2, 4
# The trainer: 1 epoch of 2 steps at B=4 per stage, then a rollout of 2
# videos of 9 frames with the restored best weights.
STAGE_B, STAGE_STEPS, STAGE_ROLL_T = 4, 2, 9
# The data phases: a GTEA tree, written to a temporary directory removed
# at the end, of DATA_V videos x DATA_T frames at the native 720x960 (two
# videos per subject), JPEG quality DATA_QUALITY; the odd videos have
# untracked rows at DATA_UNTRACKED (NaN, the (0, 0) sentinel, a point
# past the frame), the first DATA_FIXSAC have fixsac files (I-DT labels
# the rest), the last has no gaze txt; one more video (DATA_AVI) goes
# through an MJPEG AVI and extract_dataset. Decoded frames must lie
# within DATA_PSNR_MIN dB of their sources (a sanity check of the codec).
DATA_V, DATA_T, DATA_HW, DATA_FIXSAC, DATA_QUALITY = 8, 33, (720, 960), 4, 95
DATA_SUBJECTS, DATA_AVI, DATA_UNTRACKED = ("S1", "S2", "S3", "S4"), "S5_Avi", (5, 12, 20)
DATA_PSNR_MIN = 30.0
# extract: the dense_flow preset at the native grid, windows of 32 pairs.
EXTRACT_B = 32
# videos: rollout_eval_videos (turbo) in groups of 8 at chunks of 8 and 16;
# video 0's first VIDEO_CPU_FRAMES frames on the CPU too.
VIDEO_GROUP, VIDEO_CHUNKS, VIDEO_CPU_FRAMES = 8, (8, 16), 5
# data_stages: the trainer on the tree at B=4, 1 epoch, the last subject
# held out.
DATA_STAGE_B = 4
# The tail phase: the turbo clip with the int8 fuse/decoder tail. Its
# layers at B=8: (name, output grid, kernel size); the up blocks' grids are
# the polyphase convs' (N + 1 before the depth-to-space). The tail on the
# CPU from the card's codes at B=2 must give the same codes (exact s32
# accumulators, one float32 rounding per epilogue operation on both) and
# the saliency within the sigmoid's ulps. A server on the reloaded bundle
# is ticked over the clip's first frames.
TAIL_LAYERS = (("fuse", 14, 1), ("up1", 15, 2), ("up2", 29, 2), ("up3", 57, 2),
               ("up4", 113, 2), ("out", 224, 1))
TAIL_CPU_B, TAIL_CPU_SAL_TOL, TAIL_SERVE_T = 2, 1e-6, 4
# The qat phase: parity preset, scales calibrated on 4 pairs, B=8 steps as
# train_sp's. Card vs CPU at B=2 on the same inputs: the float32 summation
# gap of train_sp (1.1e-3) flips fake-quant codes at rounding boundaries,
# and the flips cascade through the 13 layers: run free, the two steps
# differ by chaotic amounts (on an H100 at 700 W, four runs: gradients
# 1.2e-2 to 1.9e-2 relative L2, the loss 2.6e-5 to 2.8e-4, the conv5
# features 7.6e-3 to 2.2e-2 apart with 43-49% of them unequal). So the
# CPU step replays the card's quantization decisions (FakeQuantTape): each
# fake-quant point takes the card's value, which must lie within one code
# of the CPU's own rounding of its pre-activation with at most
# QAT_FLIP_SHARE of the codes one apart; the step is then held to
# train_sp's bands. The free-running conv5 gap is reported beside it.
QAT_CALIB_PAIRS = 4
QAT_FLIP_SHARE = 1e-3
# The deploy check is the JAX package's binding property
# (tests/test_qat.py:39-52): cosine > 0.999 and >= 98% of elements within
# rtol 5e-2 and an atol that is the reference's 1e-3 taken on the deployed
# grid: 18,900 conv5_3 accumulator units (act scale x weight scale) per
# channel, which is what 1e-3 is in the reference's own case
# (tests/test_torch_qat.py::test_binding_atol_on_the_deployed_grid). The
# literal 1e-3 binds only at that case's feature scale (conv5 peaking at
# 0.035): the port's He-normal weights give features of order 1, and the
# JAX package's own forwards fall below 98% with it there too.
QAT_BIND_COSINE, QAT_BIND_SHARE, QAT_BIND_RTOL, QAT_BIND_ATOL_LSB = 0.999, 0.98, 5e-2, 18900


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(torch, fn, tries: int = 3):
    """Run ``fn`` once under ``torch.profiler``. Returns the host wall
    seconds and, per device kernel name, (device µs summed, launches) from
    the CUPTI trace. The CUDA-event times above include the wrapper's host
    cost when the host enqueues slower than the card runs; these do not.
    A trace that comes back without device events (seen once in a few
    hundred traces on the card) is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        if by_name:
            break
    return wall, by_name


def device_us(by_name, part: str):
    """(device µs summed, launches) of the kernels whose name holds ``part``."""
    hits = [v for k, v in by_name.items() if part in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def busy_ms(by_name) -> float:
    """Device busy milliseconds: every kernel, copy and fill summed (one
    stream, so they do not overlap)."""
    return sum(v[0] for v in by_name.values()) / 1e3


def textures(rng, n: int, H: int, W: int, waves: int = 8):
    """``n`` smooth textures in [0.1, 0.9] as functions of a shift (dx, dy):
    sums of plane waves with wavelengths 6-40 px, evaluated exactly at
    the shifted coordinates."""
    params = [
        [(rng.uniform(0, np.pi), rng.uniform(6, 40), rng.uniform(0, 2 * np.pi))
         for _ in range(waves)]
        for _ in range(n)
    ]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)

    def at(dx: float = 0.0, dy: float = 0.0) -> np.ndarray:
        out = np.zeros((n, H, W))
        for i, waves_i in enumerate(params):
            for ang, lam, ph in waves_i:
                k = 2 * np.pi / lam
                out[i] += np.sin(k * np.cos(ang) * (xx - dx) + k * np.sin(ang) * (yy - dy) + ph)
        return (0.5 + 0.4 * out / waves).astype(np.float32)

    return at


def near_ties(hm_ref, gaze_ref, gaze_got, tie: float):
    """([stream, frame] pairs whose gaze differs at a near tie, those where
    it differs otherwise) over (N, T, ...) outputs: a pick may differ from
    the reference only where it lies within ``tie`` of the reference
    heatmap's maximum."""
    ties, mismatched = [], []
    for b in range(gaze_got.shape[0]):
        for tt in range(gaze_got.shape[1]):
            if not gaze_got[b, tt].equal(gaze_ref[b, tt]):
                gx, gy = (int(v) for v in gaze_got[b, tt])
                gap = float(hm_ref[b, tt].max() - hm_ref[b, tt, gy, gx])
                (ties if gap < tie else mismatched).append([b, tt])
    return ties, mismatched


def gaze_vs_cpu(hm_g, gaze_g, hm_c, gaze_c):
    """(near-tie frames, mismatched frames, tie threshold) of the card's
    run against the CPU's: the tie threshold is max(NEAR_TIE, 2 x the
    heatmap difference)."""
    tie = max(NEAR_TIE, 2 * float((hm_g - hm_c).abs().max()))
    return (*near_ties(hm_c, gaze_c, gaze_g, tie), tie)


def im2col_int8(torch, x, pad_code: int):
    """(B, H, W, Ci) int8 -> (B*H*W, 9*Ci) int8, tap-major: the A operand
    of the conv as one matrix product, for the ``torch._int_mm`` yardstick."""
    import torch.nn.functional as F

    Bn, H, W, ci = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), value=pad_code).permute(0, 2, 3, 1)
    cols = [xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    return torch.stack(cols, dim=3).reshape(Bn * H * W, 9 * ci)


def k3_phase(torch, dev, rng):
    """K3 against its plain version at every int8 layer shape of the turbo
    path (B=8), unpooled and, for the four stage-ending layers, with the
    fused 2x2 max-pool, and at ragged shapes, with both epilogues. Returns
    the summary row of one turbo step (24 launches: 12 layers x 2
    streams, the four stage-ending ones pooled as on the main path)."""
    import torch.nn.functional as F

    from gaze_tpu_torch.ops.conv_int8 import (ConvTap, border_table, conv3x3_int8_plain,
                                               int8_conv_acc, maxpool2x2_int8)
    from gaze_tpu_torch.ops.cuda.conv_int8 import conv3x3_int8, pad_channels

    # (layer, B, H, W, Ci, Co, dequant, pad code, pool); the int8 stem (off
    # the turbo path, whose stem is bf16) pads its Ci = 3 to 32 in the wrapper
    cases = [(name, B, g, g, ci, co, name == "conv5_3", -128, False)
             for name, g, ci, co in TURBO_INT8_LAYERS]
    cases += [(name + "+pool", B, g, g, ci, co, False, -128, True)
              for name, g, ci, co in TURBO_INT8_LAYERS if name in TURBO_POOLED_LAYERS]
    # a ragged Co and frame (odd edges dropped by the pool) with both
    # epilogues; few tiles on a 14² grid (the persistent schedule with
    # BN = 64 and most SMs idle)
    cases += [("ragged", 3, 13, 20, 64, 96, False, -128, False),
              ("ragged", 3, 13, 20, 64, 96, True, -128, False),
              ("ragged+pool", 3, 13, 20, 64, 96, False, -128, True),
              ("ragged_14x14", 3, 14, 14, 512, 512, False, -128, False),
              ("conv1_1_int8_stem", B, SIZE, SIZE, 3, 64, False, 0, False)]
    # each layer as the main path runs it
    step_layers = {name + ("+pool" if name in TURBO_POOLED_LAYERS else "")
                   for name, *_ in TURBO_INT8_LAYERS}
    step = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, library_device_ms=0.0,
                bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    k3_err = 0.0
    for name, n, H, W, ci, co, dequant, pad_code, pool in cases:
        x = torch.from_numpy(rng.integers(-128, 128, (n, H, W, ci), dtype=np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (co, 3, 3, ci), dtype=np.int8)).to(dev)
        if dequant:   # conv5_3: c = 128 * col_sum, a = sx * w_scale
            c = 128.0 * w.float().sum(dim=(1, 2, 3))
            a = torch.from_numpy(rng.uniform(1e-6, 1e-5, co).astype(np.float32)).to(dev)
            bias = torch.from_numpy(rng.normal(0, 1, co).astype(np.float32)).to(dev)
        else:         # the requant scale and offset ranges of tests/test_pallas_conv_int8.py
            a = torch.from_numpy((rng.normal(0, 2e-3, co) ** 2 + 1e-4).astype(np.float32)).to(dev)
            c = torch.from_numpy(rng.normal(-20, 40, co).astype(np.float32)).to(dev)
            bias = None
        # with its border table, as quant_taps builds the main path's taps
        tap = ConvTap(w, a, c.contiguous(), bias, pad_code, border_table(w, pad_code))
        got = conv3x3_int8(x, tap, pool=pool)
        ref = conv3x3_int8_plain(x, tap)
        if pool:
            ref = maxpool2x2_int8(ref)
        torch.cuda.synchronize()
        if got.dtype != ref.dtype or got.shape != ref.shape or not torch.equal(got, ref):
            fail(f"K3 {name} {(n, H, W, ci, co)} dequant={dequant} pool={pool}: "
                 f"{int((got != ref).sum()) if got.shape == ref.shape else 'all'} of "
                 f"{ref.numel()} outputs differ from plain")
        err = float((got.float() - ref.float()).abs().max())
        k3_err = max(k3_err, err)
        # the yardstick: one int8 matrix product of the im2col matrix (its
        # depth 9 * Ci must be a multiple of 8: the stem's padded Ci)
        wp = pad_channels(tap).w
        cip = wp.shape[-1]
        cols = im2col_int8(torch, F.pad(x, (0, cip - ci)), pad_code)
        wt = wp.reshape(co, 9 * cip).t()
        acc = torch._int_mm(cols, wt)
        if not torch.equal(acc.reshape(n, H, W, co), int8_conv_acc(x, w, pad_code)):
            fail(f"K3 {name}: the _int_mm yardstick computes another accumulator")
        big = n * H * W >= 8 * 56 * 56
        ms = cuda_ms(torch, lambda: conv3x3_int8(x, tap, pool=pool), 20 if big else 100)
        if pool:
            plain = cuda_ms(torch, lambda: maxpool2x2_int8(conv3x3_int8_plain(x, tap)), 3, 1)
        else:
            plain = cuda_ms(torch, lambda: conv3x3_int8_plain(x, tap), 3, 1)
        lib = cuda_ms(torch, lambda: torch._int_mm(cols, wt), 20 if big else 100)
        _, prof = device_profile(torch, lambda: [conv3x3_int8(x, tap, pool=pool)
                                                 for _ in range(10)])
        dev_us, dev_n = device_us(prof, "conv3x3_int8_kernel")
        # the yardstick on the device clock too: every kernel of 10 calls
        _, prof = device_profile(torch, lambda: [torch._int_mm(cols, wt) for _ in range(10)])
        lib_dev_us = busy_ms(prof) * 1e3 / 10
        ops = 2 * n * H * W * 9 * ci * co
        nbytes = n * H * W * ci + co * 9 * ci + ref.numel() * (4 if dequant else 1) \
            + 4 * co * (3 if dequant else 2)
        ops_ms, bytes_ms = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        emit("K3", layer=name, shape=[n, H, W, ci, co],
             epilogue="dequant" if dequant else "requant, 2x2 max-pool" if pool else "requant",
             max_abs_err=err, bitwise_equal=True, kernel_ms=ms,
             kernel_device_us=dev_us / dev_n if dev_n else None, plain_ms=plain,
             library_ms=lib, library_device_us=lib_dev_us, bound_us=bound * 1e3,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             tops=ops / ms / 1e9)
        if name in step_layers:   # each runs once per stream: twice per step
            step["ms"] += 2 * ms
            step["device_ms"] += 2 * (dev_us / dev_n / 1e3 if dev_n else float("nan"))
            step["plain_ms"] += 2 * plain
            step["library_ms"] += 2 * lib
            step["library_device_ms"] += 2 * lib_dev_us / 1e3
            step["bound_ms"] += 2 * bound
            step["ops_ms"] += 2 * ops_ms
            step["bytes_ms"] += 2 * bytes_ms
        del x, w, cols, acc, got, ref
    step["bound_by"] = "operations" if step.pop("ops_ms") >= step.pop("bytes_ms") else "bytes"
    step["max_abs_err"] = k3_err
    emit("K3_step", launches_per_step=2 * len(TURBO_INT8_LAYERS), **step)
    return step


def turbo_phase(torch, dev, cuda, frames, fixsac):
    """The turbo preset's main path: calibration, then the B x T clip.
    Returns what the serve and rollout phases reuse: the pipeline, its
    calibration and weights, the clip's outputs and launch counts."""
    from gaze_tpu_torch.core.config import PRESETS, preset_config
    from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
    from gaze_tpu_torch.models.quant import LAYERS, calibrate_pipeline_sp
    from gaze_tpu_torch.ops.tvl1 import _pyramid_shapes

    p = PRESETS["turbo"]
    cfg = preset_config("turbo")
    dtype = getattr(torch, p["dtype"])
    t1 = cfg.tvl1
    base = GazePipeline(cfg, dtype=dtype, seed=0)
    pairs = [(frames[:, t], frames[:, t + 1]) for t in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qsp = calibrate_pipeline_sp(base, pairs, percentile=p["quant_percentile"],
                                bf16_stem=p["quant_stem"] == "bf16")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    pipe = GazePipeline(cfg, dtype=dtype, seed=0, quant_sp=qsp)
    pipe.load_state_dicts(base.state_dicts())
    del base
    run_clip(pipe, frames[:, :2], fixsac[:, :2])   # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    heatmaps, gaze = run_clip(pipe, frames, fixsac)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = {name: k.launches for name, k in cuda.kernels().items()}
    peak = torch.cuda.max_memory_allocated()
    # the clip is host-bound and short (about 0.2 s): time it twice more
    for _ in range(2):
        t0 = time.perf_counter()
        run_clip(pipe, frames, fixsac)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    fh = int(round(SIZE * t1.flow_scale))
    levels = len(_pyramid_shapes(fh, fh, t1.pyramid_levels, t1.pyramid_factor))
    int8_layers = len(LAYERS) - (1 if p["quant_stem"] == "bf16" else 0)
    expect = {"warp3": levels * t1.warps * T, "tvl1_pd": levels * t1.warps * T,
              "conv3x3_int8": 2 * int8_layers * T}
    if launches != expect:
        fail(f"turbo: kernel launches {launches}, expected {expect}")
    if tuple(heatmaps.shape) != (B, T, SIZE, SIZE) or tuple(gaze.shape) != (B, T, 2):
        fail(f"turbo: shapes {tuple(heatmaps.shape)}, {tuple(gaze.shape)}")
    if not bool(torch.isfinite(heatmaps).all()) or not bool(torch.isfinite(gaze).all()):
        fail("turbo: non-finite outputs")
    if float(heatmaps.min()) < 0 or float(heatmaps.max()) > 1:
        fail("turbo: heatmap outside [0, 1]")
    if float(gaze.min()) < 0 or float(gaze.max()) > SIZE - 1:
        fail("turbo: gaze outside the image")

    state = pipe.init_state(B)
    prev = torch.from_numpy(frames[:, 0]).to(dev)
    cur = torch.from_numpy(frames[:, 1]).to(dev)
    fix = torch.from_numpy(fixsac[:, 1]).to(dev)
    with torch.inference_mode():
        rgb_in, flow_in = pipe.preprocess_pair(prev, cur)
        sal, feat = pipe.sp_forward(rgb_in, flow_in)
        stages = (("tvl1_preprocess", lambda: pipe.preprocess_pair(prev, cur)),
                  ("sp_int8_streams_and_tail", lambda: pipe.sp_forward(rgb_in, flow_in)),
                  ("at_lf", lambda: pipe.attend(state, sal, feat, fix)))
        stage_ms = {name: cuda_ms(torch, fn, 5, 1) for name, fn in stages}
        stage_device_ms = {name: busy_ms(device_profile(torch, fn)[1]) for name, fn in stages}
    _, prof = device_profile(torch, lambda: run_clip(pipe, frames[:, :3], fixsac[:, :3]))
    step_busy_ms = busy_ms(prof) / 2
    step_wall_ms = wall * 1e3 / T
    k3_dev_us, k3_n = device_us(prof, "conv3x3_int8_kernel")
    k2_dev_us, k2_n = device_us(prof, "pd_iterations_kernel")
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:10]
    top_kernels = [{"name": k[:90], "ms_per_step": v[0] / 2e3, "launches_per_step": v[1] / 2}
                   for k, v in top]

    # the same clip, B=1 x T=2, on the CPU with the same weights and QuantSP
    cpu = GazePipeline(cfg, dtype=dtype, device="cpu", quant_sp=qsp)
    cpu.load_state_dicts(pipe.state_dicts())
    t0 = time.perf_counter()
    hm_c, gaze_c = run_clip(cpu, frames[:1, :3], fixsac[:1, :3])
    t_cpu = time.perf_counter() - t0
    hm_g, gaze_g = heatmaps[:1, :2].cpu(), gaze[:1, :2].cpu()
    hm_diff = float((hm_g - hm_c).abs().max())
    near_ties, mismatched, tie = gaze_vs_cpu(hm_g, gaze_g, hm_c, gaze_c)
    emit("turbo", batch=B, frames=T, size=SIZE, flow_grid=fh, tvl1_levels=levels,
         tvl1_warps=t1.warps, tvl1_iters=t1.iters, dtype=p["dtype"],
         calibration_pairs=len(pairs), calibration_s=calib_s,
         frames_per_s=B * T / wall, frames_per_s_runs=[B * T / w for w in walls], wall_s=wall,
         stage_ms=stage_ms, stage_device_ms=stage_device_ms, step_wall_ms=step_wall_ms,
         step_device_busy_ms=step_busy_ms, device_idle_share=1 - step_busy_ms / step_wall_ms,
         k3_device_ms_per_step=k3_dev_us / 2e3, k3_launches_per_step=k3_n / 2,
         k2_device_ms_per_step=k2_dev_us / 2e3, k2_launches_per_step=k2_n / 2,
         launches_per_step=sum(v[1] for v in prof.values()) / 2, top_kernels=top_kernels,
         peak_mem_bytes=peak, launches=launches,
         cpu_frames=2, cpu_s=t_cpu, cpu_heatmap_max_diff=hm_diff, cpu_heatmap_tol=CPU_TURBO_TOL,
         cpu_gaze_max_diff=float((gaze_g - gaze_c).abs().max()),
         cpu_near_tie_frames=near_ties, cpu_near_tie_threshold=tie,
         gaze_first_stream=gaze[0].tolist())
    if mismatched:
        fail(f"turbo: gaze differs from the CPU run at frames {mismatched}")
    if not hm_diff <= CPU_TURBO_TOL:
        fail(f"turbo: heatmaps differ from the CPU run by {hm_diff} > {CPU_TURBO_TOL}")
    return dict(pipe=pipe, cfg=cfg, dtype=dtype, qsp=qsp, weights=pipe.state_dicts(),
                heatmaps=heatmaps, gaze=gaze, launches=launches, peak_mem_bytes=peak,
                k3_device_ms_per_step=k3_dev_us / 2e3,
                per_step={"warp3": levels * t1.warps, "tvl1_pd": levels * t1.warps,
                          "conv3x3_int8": 2 * int8_layers})


def serve_phase(torch, cuda, turbo, frames, fixsac, rng):
    """The turbo ``StreamServer``: a run of submit() calls with attach and
    detach under way, then direct ticks; and a second server ticked over
    the turbo clip, held against ``run_clip``'s outputs. Returns the
    submit run's launch counts, its frame batches, its gaze per frame and
    the direct ticks' gaze."""
    from gaze_tpu_torch.serve import StreamServer

    cfg, dtype, qsp, weights = turbo["cfg"], turbo["dtype"], turbo["qsp"], turbo["weights"]
    per_tick = turbo["per_step"]
    S, n = SERVE_STREAMS, SERVE_TICKS
    pad = 8
    canvas = textures(rng, 3 * S, SIZE + 2 * pad, SIZE + 2 * pad)()
    canvas = np.round(canvas.reshape(S, 3, SIZE + 2 * pad, SIZE + 2 * pad).transpose(0, 2, 3, 1)
                      * 255).astype(np.uint8)
    drift = np.clip(np.cumsum(rng.integers(-1, 2, (n, S, 2)), axis=0), -pad, pad) + pad
    batches = [np.stack([canvas[i, y:y + SIZE, x:x + SIZE] for i, (x, y) in enumerate(d)])
               for d in drift]

    def server(streams, **kw):
        return StreamServer(cfg, weights, streams, dtype=dtype, quant_sp=qsp, **kw)

    warm = server(S)                      # cuDNN plans and allocator at S streams
    for i in range(S):
        warm.attach(i)
    warm.tick(batches[0])
    warm.tick(batches[1])
    del warm

    srv = server(S)                       # online I-DT fixations
    first = list(range(S_ATTACHED))
    for i in first:
        srv.attach(i)
    active = set(first)
    fresh = set(first)
    expect_active, expect_fresh = {}, {}   # per frame, the slots as its tick saw them

    def launches():
        return {k: v.launches for k, v in cuda.kernels().items()}

    def check_launches(ticks, where):
        want = {k: v * ticks for k, v in per_tick.items()}
        if launches() != want:
            fail(f"serve: {where}: kernel launches {launches()}, expected {want}")

    results, submit_ms = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t_start = time.perf_counter()
    for t in range(n):
        if t == SERVE_SWAP_AT:            # a submit is in flight: attach/detach drain it
            for i in SERVE_DETACH:
                srv.detach(i)
                active.discard(i)
            for i in SERVE_ATTACH:
                srv.attach(i)
                active.add(i)
                fresh.add(i)
            check_launches(t, "after the attach/detach drain")
        expect_active[t], expect_fresh[t] = set(active), set(fresh)
        fresh = set()
        t0 = time.perf_counter()
        r = srv.submit(batches[t])
        dt = time.perf_counter() - t0
        check_launches(t, f"submit {t}")
        if t == 0:
            if r is not None:
                fail("serve: the first submit returned a result")
            continue
        if r is None:
            fail(f"serve: submit {t} returned no result")
        results[t - 1] = r["gaze"]
        if t != SERVE_SWAP_AT:            # the stashed result ran no tick here
            submit_ms.append(dt * 1e3)
    r = srv.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    results[n - 1] = r["gaze"]
    check_launches(n, "flush")
    submit_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    stream_frames = sum(len(expect_active[f]) for f in range(n))
    for f in range(n):
        g = results[f]
        for i in range(S):
            sentinel = i not in expect_active[f] or i in expect_fresh[f]
            if sentinel and not (g[i] == -1).all():
                fail(f"serve: frame {f} slot {i}: gaze {g[i].tolist()}, expected (-1, -1)")
            if not sentinel and not (np.isfinite(g[i]).all() and (g[i] >= 0).all()
                                     and (g[i] <= SIZE - 1).all()):
                fail(f"serve: frame {f} slot {i}: gaze {g[i].tolist()} outside the image")

    # direct ticks: their wall times, and a tick's device busy time
    tick_ms, tick_gaze = [], []
    for t in range(SERVE_DIRECT_TICKS):
        t0 = time.perf_counter()
        tick_gaze.append(srv.tick(batches[t])["gaze"])
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    _, prof = device_profile(torch, lambda: [srv.tick(batches[t]) for t in range(3)])
    tick_busy_ms = busy_ms(prof) / 3
    del srv

    # a second server with explicit fixation bits over the turbo clip
    srv = server(B, keep_heatmaps=True)
    for i in range(B):
        srv.attach(i)
    srv.tick(frames[:, 0], fixsac[:, 0])
    outs = [srv.tick(frames[:, t], fixsac[:, t]) for t in range(1, T + 1)]
    hm = torch.stack([torch.from_numpy(o["heatmap"]) for o in outs], dim=1)
    srv_gaze = torch.stack([torch.from_numpy(o["gaze"]) for o in outs], dim=1)
    ref_hm, ref_gaze = turbo["heatmaps"].float().cpu(), turbo["gaze"].cpu()
    clip_diff = float((hm - ref_hm).abs().max())
    tie = max(NEAR_TIE, 2 * clip_diff)
    clip_ties, clip_mismatched = near_ties(ref_hm, ref_gaze, srv_gaze, tie)
    del srv

    emit("serve", streams=S, attached_at_start=S_ATTACHED, ticks=n,
         swap_at=SERVE_SWAP_AT, detached=list(SERVE_DETACH), attached=list(SERVE_ATTACH),
         fixation_source="idt", stream_frames=stream_frames, submit_run_wall_s=wall,
         frames_per_s=stream_frames / wall,
         submit_ms_median=float(np.median(submit_ms)),
         submit_ms_p90=float(np.percentile(submit_ms, 90)), submit_ticks_timed=len(submit_ms),
         tick_ms_median=float(np.median(tick_ms)), tick_ms_p90=float(np.percentile(tick_ms, 90)),
         tick_device_busy_ms=tick_busy_ms,
         device_idle_share=1 - tick_busy_ms / float(np.median(tick_ms)),
         peak_mem_bytes=peak, launches=submit_launches, launches_per_tick=per_tick,
         clip_vs_run_clip_max_diff=clip_diff, clip_tol=SERVE_CLIP_TOL,
         clip_near_tie_frames=clip_ties, clip_near_tie_threshold=tie)
    if clip_mismatched:
        fail(f"serve: gaze differs from run_clip's at [stream, frame] {clip_mismatched}")
    if not clip_diff <= SERVE_CLIP_TOL:
        fail(f"serve: heatmaps differ from run_clip's by {clip_diff} > {SERVE_CLIP_TOL}")
    return {"launches": submit_launches, "batches": batches, "results": results,
            "tick_gaze": tick_gaze}



def rollout_phase(torch, cuda, turbo):
    """``rollout_eval_arrays`` with the turbo pipeline over V synthetic
    videos at two chunk lengths, and a short CPU run held to the card's
    within bands derived from the two runs' per-frame outputs. Returns
    the launch counts of the chunk_len-8 run, its inputs and its sums."""
    from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
    from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays
    from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip

    pipe, cfg = turbo["pipe"], turbo["cfg"]
    seqs = [generate_sequence(SyntheticSpec(num_frames=ROLL_T, height=SIZE, width=SIZE, seed=s))
            for s in range(ROLL_V)]
    frames, gaze, fixsac = (np.stack(x) for x in zip(*seqs))
    valid = np.ones((ROLL_V, ROLL_T), np.float32)
    v, lo, hi = ROLL_UNTRACKED
    valid[v, lo:hi] = 0.0
    gaze[v, lo:hi] = np.nan
    want_count = valid[:, 1:].sum(axis=1)
    runs = {}
    for chunk_len in ROLL_CHUNKS:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        sums = rollout_eval_arrays(pipe, frames, gaze, fixsac, valid, chunk_len=chunk_len)
        torch.cuda.synchronize()
        runs[chunk_len] = (sums, time.perf_counter() - t0,
                           {k: c.launches for k, c in cuda.kernels().items()})
    (aae_s, auc_s, cnt), secs, launches = runs[ROLL_CHUNKS[0]]
    steps = ROLL_T - 1
    expect = {k: c * steps for k, c in turbo["per_step"].items()}
    for chunk_len, (sums, _, got) in runs.items():
        if got != expect:
            fail(f"rollout chunk_len={chunk_len}: kernel launches {got}, expected {expect}")
        if not np.array_equal(sums[2], want_count):
            fail(f"rollout chunk_len={chunk_len}: counts {sums[2].tolist()}, "
                 f"expected {want_count.tolist()}")
        if not all(np.isfinite(x).all() for x in sums):
            fail(f"rollout chunk_len={chunk_len}: non-finite sums")
        if not all(np.array_equal(a, b) for a, b in zip(sums, runs[ROLL_CHUNKS[0]][0])):
            fail(f"rollout: the sums at chunk_len {chunk_len} differ from those at "
                 f"{ROLL_CHUNKS[0]}")

    # video 0's first frames on the card and on the CPU, with the same
    # weights and calibration; their per-frame outputs bound the sums'
    # difference (card_vs_cpu_bands)
    n = ROLL_CPU_FRAMES
    sub = (frames[:1, :n], gaze[:1, :n], fixsac[:1, :n], valid[:1, :n])
    cpu = GazePipeline(cfg, dtype=turbo["dtype"], device="cpu", quant_sp=turbo["qsp"])
    cpu.load_state_dicts(turbo["weights"])
    card_sums = rollout_eval_arrays(pipe, *sub, chunk_len=n)
    t0 = time.perf_counter()
    cpu_sums = rollout_eval_arrays(cpu, *sub, chunk_len=n)
    cpu_s = time.perf_counter() - t0
    hm_g, gz_g = (x.float().cpu() for x in run_clip(pipe, frames[:1, :n], fixsac[:1, :n]))
    hm_c, gz_c = (x.float() for x in run_clip(cpu, frames[:1, :n], fixsac[:1, :n]))
    aae_band, auc_band, ties, mismatched, delta = card_vs_cpu_bands(
        torch, cfg, hm_g, gz_g, hm_c, gz_c, gaze[0, :n], valid[0, :n])
    d_aae = float(abs(card_sums[0] - cpu_sums[0])[0])
    d_auc = float(abs(card_sums[1] - cpu_sums[1])[0])
    scored = float(cnt.sum())
    emit("rollout", videos=ROLL_V, frames=ROLL_T, size=SIZE, untracked=list(ROLL_UNTRACKED),
         chunk_lens=list(ROLL_CHUNKS), seconds=secs,
         seconds_by_chunk_len={str(k): r[1] for k, r in runs.items()},
         frames_per_s=scored / secs, mean_aae_deg=float(aae_s.sum() / scored),
         mean_auc=float(auc_s.sum() / scored), counts=cnt.tolist(),
         aae_sums=aae_s.tolist(), auc_sums=auc_s.tolist(), launches=launches,
         cpu_frames=n, cpu_s=cpu_s, cpu_count=float(cpu_sums[2][0]),
         cpu_aae_sum_diff=d_aae, cpu_aae_band=aae_band, cpu_auc_sum_diff=d_auc,
         cpu_auc_band=auc_band, cpu_heatmap_max_diff=delta, cpu_near_tie_frames=ties)
    if mismatched:
        fail(f"rollout: the card's gaze differs from the CPU run's at {mismatched}")
    if cpu_sums[2][0] != card_sums[2][0] or not (d_aae <= aae_band and d_auc <= auc_band):
        fail(f"rollout: card vs CPU: count {card_sums[2][0]} vs {cpu_sums[2][0]}, AAE sum "
             f"{d_aae} (band {aae_band}), AUC sum {d_auc} (band {auc_band})")
    return {"launches": launches, "inputs": (frames, gaze, fixsac, valid),
            "sums": runs[ROLL_CHUNKS[0]][0]}


def tail_phase(torch, dev, cuda, turbo, frames, fixsac):
    """The turbo preset with the int8 fuse/decoder tail: calibration with
    ``quant_tail=True``, the B x T clip beside the untailed turbo clip,
    every tail layer on the main path's inputs bit-equal to its plain
    version and timed, the tail on the card against the CPU, a bundle
    round trip and a server on it. Returns the clip's launch counts."""
    from gaze_tpu_torch.core.config import PRESETS
    from gaze_tpu_torch.models.decode_fast import depth_to_space_offset_nhwc
    from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
    from gaze_tpu_torch.models.quant import calibrate_pipeline_sp, quant_vgg_forward
    from gaze_tpu_torch.models.quant_io import load_quant_sp, save_quant_sp
    from gaze_tpu_torch.models.quant_tail import (quantize_tail_input, tail_epilogue, tail_input,
                                                  tail_layer, tail_taps)
    from gaze_tpu_torch.ops.int8_gemm import conv_valid_int8_plain, im2col_valid, int_mm_padded
    from gaze_tpu_torch.serve import StreamServer

    p = PRESETS["turbo"]
    cfg, dtype, weights = turbo["cfg"], turbo["dtype"], turbo["weights"]
    base = GazePipeline(cfg, dtype=dtype, seed=0)
    base.load_state_dicts(weights)
    pairs = [(frames[:, t], frames[:, t + 1]) for t in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qsp = calibrate_pipeline_sp(base, pairs, percentile=p["quant_percentile"], quant_tail=True,
                                bf16_stem=p["quant_stem"] == "bf16")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del base
    pipe = GazePipeline(cfg, dtype=dtype, seed=0, quant_sp=qsp)
    pipe.load_state_dicts(weights)
    run_clip(pipe, frames[:, :2], fixsac[:, :2])   # warm-up: the GEMMs' plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    heatmaps, gaze = run_clip(pipe, frames, fixsac)
    torch.cuda.synchronize()
    walls = {"tail": [time.perf_counter() - t0], "untailed": []}
    launches = launch_counts(cuda)
    peak = torch.cuda.max_memory_allocated()
    expect = {k: v * T for k, v in turbo["per_step"].items()}
    if launches != expect:
        fail(f"tail: kernel launches {launches}, expected {expect}")
    if tuple(heatmaps.shape) != (B, T, SIZE, SIZE) or tuple(gaze.shape) != (B, T, 2):
        fail(f"tail: shapes {tuple(heatmaps.shape)}, {tuple(gaze.shape)}")
    if not bool(torch.isfinite(heatmaps).all()) or not bool(torch.isfinite(gaze).all()):
        fail("tail: non-finite outputs")
    if float(heatmaps.min()) < 0 or float(heatmaps.max()) > 1:
        fail("tail: heatmap outside [0, 1]")
    # the same clip with and without the tail, in turns
    for order in (("untailed", "tail"), ("tail", "untailed"), ("untailed", "tail")):
        for name in order:
            t0 = time.perf_counter()
            run_clip(pipe if name == "tail" else turbo["pipe"], frames, fixsac)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    wall = {k: float(np.median(v)) for k, v in walls.items()}
    busy = {}
    for name, pl in (("tail", pipe), ("untailed", turbo["pipe"])):
        _, prof = device_profile(torch, lambda: run_clip(pl, frames[:, :3], fixsac[:, :3]))
        busy[name] = busy_ms(prof) / 2

    # every tail layer on the main path's inputs (the clip's first step)
    qt = pipe.quant_sp.tail
    taps = tail_taps(qt)
    prev = torch.from_numpy(frames[:, 0]).to(dev)
    cur = torch.from_numpy(frames[:, 1]).to(dev)
    step = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                bytes_ms=0.0)
    with torch.inference_mode():
        rgb_in, flow_in = pipe.preprocess_pair(prev, cur)
        f_s = quant_vgg_forward(pipe.quant_sp.spatial, rgb_in)
        f_t = quant_vgg_forward(pipe.quant_sp.temporal, flow_in)
        xq = quantize_tail_input(qt, f_s, f_t)
        inputs = {}
        for name, grid, k in TAIL_LAYERS:
            tap = taps[name]
            inputs[name] = xq
            xin = tail_input(tap, xq)
            got = tail_layer(tap, xq)
            ref = tail_epilogue(tap, conv_valid_int8_plain(xin, tap.w, k))
            torch.cuda.synchronize()
            want_shape = (B, grid, grid) if name == "out" else (B, grid, grid, tap.w.shape[0])
            if tuple(got.shape) != want_shape:
                fail(f"tail {name}: shape {tuple(got.shape)}, expected {want_shape}")
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                fail(f"tail {name}: {int((got != ref).sum())} of {ref.numel()} outputs differ "
                     f"from the plain version")
            big = B * grid * grid >= 8 * 56 * 56
            ms = cuda_ms(torch, lambda: tail_layer(tap, xq), 20 if big else 100)
            plain = cuda_ms(torch, lambda: tail_epilogue(
                tap, conv_valid_int8_plain(tail_input(tap, xq), tap.w, k)), 3, 1)
            cols = im2col_valid(xin, k)
            lib = cuda_ms(torch, lambda: int_mm_padded(cols, tap.w), 20 if big else 100)
            _, prof = device_profile(torch, lambda: [tail_layer(tap, xq) for _ in range(10)])
            dev_ms = busy_ms(prof) / 10
            m_rows, depth, width = cols.shape[0], cols.shape[1], tap.w.shape[0]
            ops = 2 * m_rows * depth * width
            nbytes = xq.numel() + tap.w.numel() + got.numel() * got.element_size() \
                + 4 * width * (3 if name == "out" else 2)
            ops_ms, bytes_ms = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            row = dict(layer=name, gemm=[m_rows, depth, width], input=list(xq.shape),
                       bitwise_equal=True, ms=ms, device_ms=dev_ms, plain_ms=plain,
                       gemm_ms=lib, bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       tops=ops / ms / 1e9)
            emit("tail_layer", **row)
            for key, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", row["bound_ms"]),
                           ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                step[key] += v
            if name != "out":
                xq = got if name == "fuse" else depth_to_space_offset_nhwc(got, got.shape[-1] // 4)
            del cols
    step["bound_by"] = "operations" if step.pop("ops_ms") >= step.pop("bytes_ms") else "bytes"

    # the tail on the CPU from the same codes: each layer's output equal
    qt_cpu = qt.to("cpu")
    taps_cpu = tail_taps(qt_cpu)
    cpu_flips, cpu_sal_diff = {}, 0.0
    with torch.inference_mode():
        for name, _, _ in TAIL_LAYERS:
            x_cpu = inputs[name][:TAIL_CPU_B].cpu()
            got_c = tail_layer(taps_cpu[name], x_cpu)
            got_g = tail_layer(taps[name], inputs[name][:TAIL_CPU_B]).cpu()
            if name == "out":
                cpu_sal_diff = float((got_c - got_g).abs().max())
            else:
                d = (got_c.to(torch.int16) - got_g.to(torch.int16)).abs()
                cpu_flips[name] = [int((d != 0).sum()), int(d.max()), d.numel()]
    # the whole clip, B=1 x T=2, on the CPU with the same weights and QuantSP
    cpu = GazePipeline(cfg, dtype=dtype, device="cpu", quant_sp=qsp)
    cpu.load_state_dicts(weights)
    t0 = time.perf_counter()
    hm_c, gaze_c = run_clip(cpu, frames[:1, :3], fixsac[:1, :3])
    t_cpu = time.perf_counter() - t0
    hm_g, gaze_g = heatmaps[:1, :2].cpu(), gaze[:1, :2].cpu()
    hm_diff = float((hm_g - hm_c).abs().max())
    ties, mismatched, tie = gaze_vs_cpu(hm_g, gaze_g, hm_c, gaze_c)

    # the bundle: written, read back, served
    d = tempfile.mkdtemp(prefix="chip_smoke_tail_")
    try:
        save_quant_sp(os.path.join(d, "bundle"), qsp)
        back = load_quant_sp(os.path.join(d, "bundle"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for part in ("spatial", "temporal", "tail"):
        a, b = getattr(qsp, part), getattr(back, part)
        for field in ("kernels", "w_scales", "biases", "act_scales", "col_sums"):
            for k, v in getattr(a, field).items():
                if not torch.equal(getattr(b, field)[k], v.cpu()):
                    fail(f"tail: the bundle's {part}.{field}.{k} did not come back")
    srv = StreamServer(cfg, weights, B, dtype=dtype, quant_sp=back, keep_heatmaps=True)
    for i in range(B):
        srv.attach(i)
    cuda.reset_launch_counts()
    srv.tick(frames[:, 0], fixsac[:, 0])
    outs = [srv.tick(frames[:, t], fixsac[:, t]) for t in range(1, TAIL_SERVE_T + 1)]
    srv_launches = launch_counts(cuda)
    del srv
    srv_hm = torch.stack([torch.from_numpy(o["heatmap"]) for o in outs], dim=1)
    srv_gaze = torch.stack([torch.from_numpy(o["gaze"]) for o in outs], dim=1)
    ref_hm = heatmaps[:, :TAIL_SERVE_T].float().cpu()
    ref_gaze = gaze[:, :TAIL_SERVE_T].cpu()
    srv_diff = float((srv_hm - ref_hm).abs().max())
    srv_ties, srv_mismatched = near_ties(ref_hm, ref_gaze, srv_gaze, max(NEAR_TIE, 2 * srv_diff))
    srv_expect = {k: v * (TAIL_SERVE_T + 1) for k, v in turbo["per_step"].items()}

    emit("tail", batch=B, frames=T, size=SIZE, calibration_pairs=len(pairs),
         calibration_s=calib_s, act_scales={k: float(v) for k, v in qt.act_scales.items()},
         frames_per_s=B * T / wall["tail"], untailed_frames_per_s=B * T / wall["untailed"],
         wall_s_runs=walls, step_wall_ms=wall["tail"] * 1e3 / T,
         untailed_step_wall_ms=wall["untailed"] * 1e3 / T, step_device_busy_ms=busy["tail"],
         untailed_step_device_busy_ms=busy["untailed"],
         device_idle_share=1 - busy["tail"] / (wall["tail"] * 1e3 / T),
         untailed_device_idle_share=1 - busy["untailed"] / (wall["untailed"] * 1e3 / T),
         peak_mem_bytes=peak, untailed_peak_mem_bytes=turbo["peak_mem_bytes"],
         launches=launches, launches_per_step=turbo["per_step"], tail_step=step,
         cpu_same_codes_batch=TAIL_CPU_B, cpu_code_flips=cpu_flips,
         cpu_saliency_max_diff=cpu_sal_diff, cpu_frames=2, cpu_s=t_cpu,
         cpu_heatmap_max_diff=hm_diff, cpu_heatmap_tol=CPU_TURBO_TOL,
         cpu_near_tie_frames=ties, cpu_near_tie_threshold=tie,
         server_ticks=TAIL_SERVE_T + 1, server_launches=srv_launches,
         server_vs_run_clip_max_diff=srv_diff, server_tol=SERVE_CLIP_TOL,
         server_near_tie_frames=srv_ties, gaze_first_stream=gaze[0].tolist())
    if any(f[1] > 0 for f in cpu_flips.values()) or not cpu_sal_diff <= TAIL_CPU_SAL_TOL:
        fail(f"tail: the card's layers differ from the CPU's on the same codes: {cpu_flips}, "
             f"saliency {cpu_sal_diff} (tol {TAIL_CPU_SAL_TOL})")
    if mismatched:
        fail(f"tail: gaze differs from the CPU run at frames {mismatched}")
    if not hm_diff <= CPU_TURBO_TOL:
        fail(f"tail: heatmaps differ from the CPU run by {hm_diff} > {CPU_TURBO_TOL}")
    if srv_launches != srv_expect:
        fail(f"tail: the server launched {srv_launches}, expected {srv_expect}")
    if srv_mismatched or not srv_diff <= SERVE_CLIP_TOL:
        fail(f"tail: the server on the loaded bundle differs from run_clip: heatmaps "
             f"{srv_diff} (tol {SERVE_CLIP_TOL}), gaze at {srv_mismatched}")
    del pipe, cpu, heatmaps, gaze
    return launches


# ------------------------------------------------------------ training ----
def k2_plain(args, kw, passes):
    """K2's plain version: the iterations, then the median passes."""
    from gaze_tpu_torch.ops.cuda.tvl1_pd import pd_iterations_plain
    from gaze_tpu_torch.ops.image import median3x3

    out = pd_iterations_plain(*args, **kw)
    f1, f2 = out[:2]
    for _ in range(passes):
        f1, f2 = median3x3(f1), median3x3(f2)
    return (f1, f2, *out[2:])


class CheckedKernels:
    """While active, every K1 and K2 call that TV-L1 makes also runs the
    kernel's plain version on the same inputs (on the card, launching
    nothing) and records whether the two agree bit for bit and their
    largest difference."""

    def __init__(self, torch):
        from gaze_tpu_torch.ops.cuda import tvl1_pd, warp
        from gaze_tpu_torch.ops.warp import warp3_plain

        self.torch, self.warp, self.pd = torch, warp, tvl1_pd
        self.orig = (warp.warp3, tvl1_pd.pd_iterations)
        self.warp3_plain = warp3_plain
        self.calls = {"warp3": 0, "tvl1_pd": 0}
        self.equal = {"warp3": True, "tvl1_pd": True}
        self.err = {"warp3": 0.0, "tvl1_pd": 0.0}
        self.grad_inputs = 0

    def _note(self, name, got, ref, args):
        self.calls[name] += 1
        self.grad_inputs += sum(bool(a.requires_grad) for a in args)
        self.equal[name] &= all(self.torch.equal(g, r) for g, r in zip(got, ref))
        self.err[name] = max(self.err[name], max(float((g - r).abs().max())
                                                 for g, r in zip(got, ref)))

    def __enter__(self):
        warp3, pd = self.orig

        def checked_warp3(*args):
            got = warp3(*args)
            self._note("warp3", got, self.warp3_plain(*args), args)
            return got

        def checked_pd(*args, median_passes=0, **kw):
            got = pd(*args, median_passes=median_passes, **kw)
            self._note("tvl1_pd", got, k2_plain(args, kw, median_passes), args)
            return got

        self.warp.warp3, self.pd.pd_iterations = checked_warp3, checked_pd
        return self

    def __exit__(self, *exc):
        self.warp.warp3, self.pd.pd_iterations = self.orig
        return False

    def check(self, where, per_call_kernels):
        """Fail unless every checked call was bit-equal and saw no tensor
        that requires grad; ``per_call_kernels`` the calls expected."""
        if self.calls != per_call_kernels:
            fail(f"{where}: checked kernel calls {self.calls}, expected {per_call_kernels}")
        if self.grad_inputs:
            fail(f"{where}: {self.grad_inputs} kernel inputs required grad")
        if not all(self.equal.values()):
            fail(f"{where}: kernels differ from their plain versions inside the step: "
                 f"max abs {self.err}")
        return {"bitwise_equal": True, "max_abs_err": dict(self.err)}


def launch_counts(cuda):
    return {k: v.launches for k, v in cuda.kernels().items()}


def flow_launches(cfg, steps: int):
    """K1/K2 launches of ``steps`` preprocess_pair calls: one K1 and one
    K2 per (level, warp) of the solve's grid."""
    from gaze_tpu_torch.ops.tvl1 import _pyramid_shapes

    t1 = cfg.tvl1
    fh = int(round(cfg.image.height * t1.flow_scale))
    fw = int(round(cfg.image.width * t1.flow_scale))
    n = len(_pyramid_shapes(fh, fw, t1.pyramid_levels, t1.pyramid_factor)) * t1.warps * steps
    return {"warp3": n, "tvl1_pd": n, "conv3x3_int8": 0}


def sp_batches(cfg, batch: int, n: int, seed: int = 0):
    """n SP batches of the port's synthetic corpus at the config's grid."""
    from gaze_tpu_torch.data.synthetic import SyntheticSpec, batch_iterator

    spec = SyntheticSpec(num_frames=64, height=cfg.image.height, width=cfg.image.width,
                         seed=seed)
    return list(batch_iterator(spec, batch, n, seed=seed))


def grad_compare(got, want, names):
    """Gradients of the same step from two runs. Returns the whole
    model's relative L2 difference ``|got - want| / |want|`` (the checked
    number), each tensor's relative Frobenius difference (the five
    largest, by name) and the largest elementwise difference over its
    tensor's largest value. A ReLU whose input lies within rounding of 0
    can switch on one side and not the other; that switches one term of
    a weight gradient's sum (conv5_3's sums over B x 14 x 14 positions),
    so single elements may differ by far more than the model's gradient
    does."""
    got = [g.detach().float().cpu() for g in got]
    want = [w.detach().float().cpu() for w in want]
    diff2 = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    ref2 = sum(float((w ** 2).sum()) for w in want)
    fro = sorted(((float((g - w).norm() / max(float(w.norm()), 1e-30)), n)
                  for g, w, n in zip(got, want, names)), reverse=True)[:5]
    elem = sorted(((float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30), n)
                   for g, w, n in zip(got, want, names)), reverse=True)
    return {"model_rel_l2": (diff2 / ref2) ** 0.5,
            "tensor_rel_fro_top5": [[n, e] for e, n in fro],
            "elem_rel_max": [elem[0][1], elem[0][0]],
            "tensor_elem_rel_top5": [[n, e] for e, n in elem[:5]]}


def params_max_diff(a, b, names):
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[n].cpu() - sb[n].cpu()).abs().max()) for n in names)


def stats_rel_err(a, b):
    return max(float(((a[k].cpu() - b[k].cpu()).abs() / (b[k].cpu().abs() + 1e-3)).max())
               for k in a)


def train_sp_phase(torch, cuda):
    """The SP stage's train step at full width on the parity preset (f32,
    TF32 off, TV-L1 at 224²): B=8 timed, a step with remat="encoders",
    three production-preset steps, and the first step at B=2 held to the
    CPU. Returns the trained SP state dict and the launch counts."""
    from gaze_tpu_torch.core.config import parity_config, preset_config
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.train.common import (make_optimizer, make_state,
                                             microbatch_value_and_grad, to_device)
    from gaze_tpu_torch.train.sp import create_sp_state, make_sp_train_step, sp_loss

    cfg = dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=TRAIN_B, learning_rate=TRAIN_LR))
    per_step = flow_launches(cfg, 1)
    batches = sp_batches(cfg, TRAIN_B, TRAIN_STEPS + 2)
    pipe = GazePipeline(cfg, seed=0)
    state = create_sp_state(pipe)
    init = {k: v.detach().cpu().clone() for k, v in pipe.sp.state_dict().items()}
    step = make_sp_train_step(pipe)

    # (a) and (b): the first step at B=2 on the card and on the CPU from
    # the same weights and batch
    def fresh(p):
        p.sp.load_state_dict(init)
        return make_state(p.sp, make_optimizer(cfg.train))

    small = {k: v[:TRAIN_CPU_B] for k, v in batches[0].items()}
    cpu = GazePipeline(cfg, device="cpu", seed=0)
    cpu_state = fresh(cpu)
    card = to_device(small, pipe.device)
    cpu_small = to_device(small, cpu.device)
    rgb_in, flow_in = pipe.preprocess_pair(card["prev"], card["cur"])

    def on_inputs(p, st, rgb, flow, mb):
        (loss, stats), g = microbatch_value_and_grad(
            lambda m: sp_loss(p, rgb, flow, m), st.params, mb, 1)
        return loss, stats, g

    loss_g, stats_g, grads_g = on_inputs(pipe, state, rgb_in, flow_in, card)
    flow_leaf = flow_in.clone().requires_grad_()
    g_flow = torch.autograd.grad(sp_loss(pipe, rgb_in, flow_leaf, card)[0], flow_leaf)[0]
    t0 = time.perf_counter()
    loss_c, stats_c, grads_c = on_inputs(cpu, cpu_state, rgb_in.cpu(), flow_in.cpu(), cpu_small)
    cpu_a_s = time.perf_counter() - t0
    a = {"loss_rel_err": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))}
    a["grads"] = grad_compare(grads_g, grads_c, state.param_names)
    a.update({
              "batch_stats_rel_err": stats_rel_err(stats_g, stats_c)})
    # the same gradients on the card with cuDNN held to its deterministic
    # algorithms (no benchmark search), and with cuDNN off (PyTorch's own
    # convolutions): does cuDNN's choice of algorithm set the gap?
    a["grads_by_cudnn_mode"] = {}
    for mode, flags in (("deterministic", dict(deterministic=True, benchmark=False)),
                        ("cudnn_off", dict(enabled=False))):
        saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
        try:
            for k, v in flags.items():
                setattr(torch.backends.cudnn, k, v)
            _, _, g = on_inputs(pipe, state, rgb_in, flow_in, card)
        finally:
            for k, v in saved.items():
                setattr(torch.backends.cudnn, k, v)
        a["grads_by_cudnn_mode"][mode] = grad_compare(g, grads_c, state.param_names)
        del g
    state.apply_gradients(grads_g, stats_g)
    cpu_state.apply_gradients(grads_c, stats_c)
    a["params_max_abs_diff"] = params_max_diff(pipe.sp, cpu.sp, state.param_names)
    del grads_g, grads_c
    # (b) the whole step, flow included, from the same initial state
    state, cpu_state = fresh(pipe), fresh(cpu)
    _, flow_c = cpu.preprocess_pair(cpu_small["prev"], cpu_small["cur"])
    d_flow = float((flow_in.cpu() - flow_c).abs().max())
    state, m_g = make_sp_train_step(pipe)(state, small)
    t0 = time.perf_counter()
    cpu_state, m_c = make_sp_train_step(cpu)(cpu_state, small)
    cpu_b_s = time.perf_counter() - t0
    # first order: |dL| <= sum |dL/dflow_in| * max |d flow_in|; twice that
    loss_band = TRAIN_LOSS_RTOL * abs(float(m_c["loss"])) + 2 * float(g_flow.abs().sum()) * d_flow
    b = {"flow_in_max_diff": d_flow, "loss_diff": abs(float(m_g["loss"]) - float(m_c["loss"])),
         "loss_band": loss_band,
         "params_max_abs_diff": params_max_diff(pipe.sp, cpu.sp, state.param_names),
         "batch_stats_rel_err": stats_rel_err(state.batch_stats(), cpu_state.batch_stats())}
    del cpu, cpu_state

    # B=8 from the initial weights: a warm-up step with every K1 and K2
    # call held to its plain version, then the timed steps
    state = fresh(pipe)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with CheckedKernels(torch) as chk:
        state, m = step(state, batches[0])
        torch.cuda.synchronize()
    inside = chk.check("train_sp", {"warp3": per_step["warp3"], "tvl1_pd": per_step["tvl1_pd"]})
    losses, walls, step_launches = [float(m["loss"])], [], [launch_counts(cuda)]
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        step_launches.append(launch_counts(cuda))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    for n, got in enumerate(step_launches):
        if got != per_step:
            fail(f"train_sp: step {n} launched {got}, expected {per_step}")
    main_launches = {k: sum(c[k] for c in step_launches) for k in per_step}
    if not all(np.isfinite(losses)):
        fail(f"train_sp: non-finite losses {losses}")
    _, prof = device_profile(torch, lambda: step(state, batches[TRAIN_STEPS + 1]))
    busy = busy_ms(prof)
    wall_ms = float(np.median(walls)) * 1e3
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:6]

    # one more step with remat="encoders" from the same weights: its
    # gradients against none's, and each step's peak above what was
    # allocated before it
    rcfg = dataclasses.replace(cfg, sp=dataclasses.replace(cfg.sp, remat="encoders"))
    rpipe = GazePipeline(rcfg, seed=0)
    rstate = create_sp_state(rpipe)
    rpipe.sp.load_state_dict(pipe.sp.state_dict())
    rb = to_device(batches[0], pipe.device)

    def grads_of(p, st):
        return microbatch_value_and_grad(
            lambda mb: sp_loss(p, *p.preprocess_pair(mb["prev"], mb["cur"]), mb),
            st.params, rb, 1)

    remat = grad_compare(grads_of(rpipe, rstate)[1], grads_of(pipe, state)[1],
                         state.param_names)
    peaks = {}
    for name, p, st in (("none", pipe, state), ("encoders", rpipe, rstate)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (_, stats), g = grads_of(p, st)
        st.apply_gradients(g, stats)
        del g
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    del rpipe, rstate

    # three steps of the production preset (bf16, half-grid flow)
    pcfg = dataclasses.replace(preset_config("production"), train=cfg.train)
    p_per_step = flow_launches(pcfg, 1)
    ppipe = GazePipeline(pcfg, dtype=torch.bfloat16, seed=0)
    pstate = create_sp_state(ppipe)
    pstep = make_sp_train_step(ppipe)
    pstate, _ = pstep(pstate, batches[0])      # warm-up
    p_walls, p_losses = [], []
    for i in range(3):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        pstate, m = pstep(pstate, batches[1 + i])
        torch.cuda.synchronize()
        p_walls.append(time.perf_counter() - t0)
        p_losses.append(float(m["loss"]))
        if launch_counts(cuda) != p_per_step:
            fail(f"train_sp production: step {i + 1} launched {launch_counts(cuda)}, "
                 f"expected {p_per_step}")
    del ppipe, pstate

    emit("train_sp", preset="parity", batch=TRAIN_B, size=SIZE, lr=TRAIN_LR,
         steps_timed=TRAIN_STEPS, step_wall_ms=[w * 1e3 for w in walls],
         step_wall_ms_median=wall_ms, step_wall_ms_p90=float(np.percentile(walls, 90)) * 1e3,
         step_device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
         samples_per_s=TRAIN_B / (wall_ms / 1e3), peak_mem_bytes=peak, losses=losses,
         launches_per_step=per_step, launches=main_launches, kernels_inside_step=inside,
         top_kernels=[{"name": k[:90], "ms": v[0] / 1e3, "launches": v[1]} for k, v in top],
         remat_encoders={"step_peak_bytes": peaks["encoders"], "none_step_peak_bytes":
                         peaks["none"], "grads": remat, "tol": REMAT_GRAD_RTOL},
         production={"batch": TRAIN_B, "dtype": "bfloat16", "flow_grid": SIZE // 2,
                     "step_wall_ms": [w * 1e3 for w in p_walls], "losses": p_losses,
                     "launches_per_step": p_per_step},
         cpu_first_step={"batch": TRAIN_CPU_B, "a_same_inputs": a, "b_whole_step": b,
                         "a_cpu_s": cpu_a_s, "b_cpu_s": cpu_b_s,
                         "tol": {"loss_rel": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_RTOL,
                                 "batch_stats_rel": TRAIN_STATS_RTOL,
                                 "params_abs": 2 * TRAIN_LR + 1e-6}})
    if not peaks["encoders"] < peaks["none"]:
        fail(f"train_sp: remat=encoders peak {peaks['encoders']} not below none's {peaks['none']}")
    if not remat["model_rel_l2"] <= REMAT_GRAD_RTOL:
        fail(f"train_sp: remat gradients {remat} from none's > {REMAT_GRAD_RTOL}")
    if not all(np.isfinite(p_losses)):
        fail(f"train_sp production: non-finite losses {p_losses}")
    if not (a["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and a["grads"]["model_rel_l2"] <= TRAIN_GRAD_RTOL
            and a["grads_by_cudnn_mode"]["deterministic"]["model_rel_l2"] <= TRAIN_GRAD_RTOL
            and a["batch_stats_rel_err"] <= TRAIN_STATS_RTOL
            and a["params_max_abs_diff"] <= 2 * TRAIN_LR + 1e-6):
        fail(f"train_sp: card vs CPU on the same inputs outside the bands: {a}")
    if not (b["loss_diff"] <= b["loss_band"] and b["params_max_abs_diff"] <= 2 * TRAIN_LR + 1e-6):
        fail(f"train_sp: card vs CPU whole step outside the bands: {b}")
    return {k: v.detach().clone() for k, v in pipe.sp.state_dict().items()}, main_launches


class FakeQuantTape:
    """While recording, every ``_ste_fake_quant`` call of the QAT forward
    (weights and activations, in call order) keeps its forward value on
    the host; while replaying, each call returns the recorded value, on
    its own device, with its own straight-through gradient, and counts the
    codes where the recorded value differs from its own rounding."""

    def __init__(self, torch):
        from gaze_tpu_torch.models import qat

        self.torch, self.qat, self.orig = torch, qat, qat._ste_fake_quant
        self.values, self.replaying = [], False
        self.max_code_diff, self.flipped, self.codes = 0, 0, 0

    def _record(self, x, scale, lo, hi):
        out = self.orig(x, scale, lo, hi)
        self.values.append(out.detach().cpu())
        return out

    def _replay(self, x, scale, lo, hi):
        torch = self.torch
        s = scale.detach()
        q = self.values[len(self.values) - self.pending].to(x.device)
        self.pending -= 1
        with torch.no_grad():
            d = (torch.round(q / s) - torch.clamp(torch.round(x / s), lo, hi)).abs()
            self.max_code_diff = max(self.max_code_diff, int(d.max()))
            self.flipped += int((d != 0).sum())
            self.codes += d.numel()
        x_c = torch.minimum(torch.maximum(x, lo * s), hi * s)
        return x_c + (q - x_c).detach()

    def __call__(self, replay: bool):
        self.replaying = replay
        self.pending = len(self.values)
        return self

    def __enter__(self):
        self.qat._ste_fake_quant = self._replay if self.replaying else self._record
        return self

    def __exit__(self, *exc):
        self.qat._ste_fake_quant = self.orig
        return False


def qat_phase(torch, cuda, sp_state):
    """QAT at full width on the parity preset, from the trained SP: the
    scales calibrated on 4 pairs and their file round trip, the first step
    at B=2 against the CPU, B=8 steps (a warm-up with every K1/K2 call
    held to its plain version, then timed), a remat="encoders" step, and
    the deploy check (the fake-quant conv5 against K3's chain on the QAT
    scales). Returns the steps' launch counts."""
    from gaze_tpu_torch.core.config import parity_config
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.models.qat import load_act_scales, qat_vgg_forward, save_act_scales
    from gaze_tpu_torch.models.quant import build_quant_vgg, quant_vgg_forward
    from gaze_tpu_torch.train.common import (make_optimizer, make_state,
                                             microbatch_value_and_grad, to_device)
    from gaze_tpu_torch.train.qat import calibrate_qat_scales, make_qat_train_step, qat_loss
    from gaze_tpu_torch.train.sp import create_sp_state

    cfg = dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=TRAIN_B, learning_rate=TRAIN_LR))
    per_step = flow_launches(cfg, 1)
    batches = sp_batches(cfg, TRAIN_B, TRAIN_STEPS + 2)
    calib = sp_batches(cfg, TRAIN_B, QAT_CALIB_PAIRS, seed=1)
    pairs = [(b["prev"], b["cur"]) for b in calib]
    pipe = GazePipeline(cfg, seed=0)
    dev = pipe.device
    pipe.sp.load_state_dict(sp_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = calibrate_qat_scales(pipe, pairs)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    d = tempfile.mkdtemp(prefix="chip_smoke_qat_")
    try:
        save_act_scales(d, scales)
        back = load_act_scales(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not all(torch.equal(back[s][k], v.cpu()) for s in scales for k, v in scales[s].items()):
        fail("qat: the scales file did not come back")
    init = {k: v.detach().cpu().clone() for k, v in pipe.sp.state_dict().items()}

    def fresh(p):
        p.sp.load_state_dict(init)
        return make_state(p.sp, make_optimizer(cfg.train))

    def grads_on(p, st, sc, rgb, flow, mb):
        return microbatch_value_and_grad(lambda m: qat_loss(p, sc, rgb, flow, m), st.params,
                                         mb, 1)

    # the first step at B=2 on the card and on the CPU, on the card's inputs
    small = {k: v[:TRAIN_CPU_B] for k, v in batches[0].items()}
    card = to_device(small, dev)
    state = fresh(pipe)
    rgb_in, flow_in = pipe.preprocess_pair(card["prev"], card["cur"])
    tape = FakeQuantTape(torch)
    with tape(replay=False):
        (loss_g, stats_g), grads_g = grads_on(pipe, state, scales, rgb_in, flow_in, card)
    cpu = GazePipeline(cfg, device="cpu", seed=0)
    cpu_state = fresh(cpu)
    cpu_scales = {s: {k: v.cpu() for k, v in d_.items()} for s, d_ in scales.items()}
    t0 = time.perf_counter()
    with tape(replay=True):
        (loss_c, stats_c), grads_c = grads_on(cpu, cpu_state, cpu_scales, rgb_in.cpu(),
                                              flow_in.cpu(), to_device(small, cpu.device))
    cpu_s = time.perf_counter() - t0
    a = {"fake_quant_points": len(tape.values), "replayed": len(tape.values) - tape.pending,
         "codes": tape.codes, "flipped_codes": tape.flipped,
         "max_code_diff": tape.max_code_diff,
         "loss_rel_err": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
         "grads": grad_compare(grads_g, grads_c, state.param_names),
         "batch_stats_rel_err": stats_rel_err(stats_g, stats_c)}
    with torch.no_grad():   # the free-running forwards: conv5 of both streams
        for stream, x in (("spatial", rgb_in), ("temporal", flow_in)):
            f_g = qat_vgg_forward(getattr(pipe.sp, stream), scales[stream], x).cpu()
            f_c = qat_vgg_forward(getattr(cpu.sp, stream), cpu_scales[stream], x.cpu())
            a[f"conv5_{stream}"] = {"rel_l2": float((f_g - f_c).norm() / f_c.norm()),
                                    "unequal_share": float((f_g != f_c).double().mean())}
    state.apply_gradients(grads_g, stats_g)
    cpu_state.apply_gradients(grads_c, stats_c)
    a["params_max_abs_diff"] = params_max_diff(pipe.sp, cpu.sp, state.param_names)
    del cpu, cpu_state, grads_g, grads_c

    # B=8 from the trained SP: a warm-up step with every K1/K2 call held to
    # its plain version, then the timed steps
    state = fresh(pipe)
    step = make_qat_train_step(pipe, scales)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with CheckedKernels(torch) as chk:
        state, m = step(state, batches[0])
        torch.cuda.synchronize()
    inside = chk.check("qat", {"warp3": per_step["warp3"], "tvl1_pd": per_step["tvl1_pd"]})
    losses, walls, step_launches = [float(m["loss"])], [], [launch_counts(cuda)]
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        step_launches.append(launch_counts(cuda))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    for n, got in enumerate(step_launches):
        if got != per_step:
            fail(f"qat: step {n} launched {got}, expected {per_step}")
    main_launches = {k: sum(c[k] for c in step_launches) for k in per_step}
    if not all(np.isfinite(losses)):
        fail(f"qat: non-finite losses {losses}")
    _, prof = device_profile(torch, lambda: step(state, batches[TRAIN_STEPS + 1]))
    busy = busy_ms(prof)
    wall_ms = float(np.median(walls)) * 1e3
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:6]

    # a remat="encoders" step's gradients against none's, same weights
    rcfg = dataclasses.replace(cfg, sp=dataclasses.replace(cfg.sp, remat="encoders"))
    rpipe = GazePipeline(rcfg, seed=0)
    rstate = create_sp_state(rpipe)
    rpipe.sp.load_state_dict(pipe.sp.state_dict())
    rb = to_device(batches[0], dev)
    r_rgb, r_flow = pipe.preprocess_pair(rb["prev"], rb["cur"])
    g_remat = grads_on(rpipe, rstate, scales, r_rgb, r_flow, rb)[1]
    g_none = grads_on(pipe, state, scales, r_rgb, r_flow, rb)[1]
    remat = grad_compare(g_remat, g_none, state.param_names)
    remat["bitwise_equal"] = all(torch.equal(x, y) for x, y in zip(g_remat, g_none))
    del rpipe, rstate, g_remat, g_none

    # deploy: the QAT weights through the PTQ path on the QAT scales (int8
    # stem), K3's chain against the fake-quant forward
    deploy, k3_launches = {}, 0
    with torch.no_grad():
        for stream, x in (("spatial", r_rgb), ("temporal", r_flow)):
            vgg = getattr(pipe.sp, stream)
            q = build_quant_vgg(vgg, scales[stream])
            cuda.reset_launch_counts()
            integer = quant_vgg_forward(q, x)
            k3_launches += launch_counts(cuda)["conv3x3_int8"]
            fake = qat_vgg_forward(vgg, scales[stream], x)
            a_, b_ = fake.double().flatten(), integer.double().flatten()
            err = (fake - integer).abs()
            grid = QAT_BIND_ATOL_LSB * q.act_scales["conv5_3"] * q.w_scales["conv5_3"]
            deploy[stream] = {
                "cosine": float(a_ @ b_ / (a_.norm() * b_.norm())),
                "close_share": float((err <= QAT_BIND_RTOL * integer.abs() + grid).double().mean()),
                "close_share_atol_1e-3": float(torch.isclose(
                    fake, integer, rtol=QAT_BIND_RTOL, atol=1e-3).double().mean()),
                "atol_grid_median": float(grid.median()),
                "feature_max": float(integer.abs().max())}
    emit("qat", preset="parity", batch=TRAIN_B, size=SIZE, lr=TRAIN_LR,
         calibration_pairs=QAT_CALIB_PAIRS, calibration_s=calib_s, steps_timed=TRAIN_STEPS,
         step_wall_ms=[w * 1e3 for w in walls], step_wall_ms_median=wall_ms,
         step_wall_ms_p90=float(np.percentile(walls, 90)) * 1e3, step_device_busy_ms=busy,
         device_idle_share=1 - busy / wall_ms, samples_per_s=TRAIN_B / (wall_ms / 1e3),
         peak_mem_bytes=peak, losses=losses, launches_per_step=per_step,
         launches=main_launches, kernels_inside_step=inside,
         top_kernels=[{"name": k[:90], "ms": v[0] / 1e3, "launches": v[1]} for k, v in top],
         remat_encoders={"grads": remat, "tol": REMAT_GRAD_RTOL},
         cpu_first_step={"batch": TRAIN_CPU_B, "same_inputs_card_codes": a, "cpu_s": cpu_s,
                         "tol": {"flip_share": QAT_FLIP_SHARE, "loss_rel": TRAIN_LOSS_RTOL,
                                 "grad_rel": TRAIN_GRAD_RTOL,
                                 "batch_stats_rel": TRAIN_STATS_RTOL,
                                 "params_abs": 2 * TRAIN_LR + 1e-6}},
         deploy=deploy, deploy_k3_launches=k3_launches)
    if not remat["model_rel_l2"] <= REMAT_GRAD_RTOL:
        fail(f"qat: remat gradients {remat} from none's > {REMAT_GRAD_RTOL}")
    if not (a["replayed"] == a["fake_quant_points"] > 0 and a["max_code_diff"] <= 1
            and a["flipped_codes"] <= QAT_FLIP_SHARE * a["codes"]
            and a["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and a["grads"]["model_rel_l2"] <= TRAIN_GRAD_RTOL
            and a["batch_stats_rel_err"] <= TRAIN_STATS_RTOL
            and a["params_max_abs_diff"] <= 2 * TRAIN_LR + 1e-6):
        fail(f"qat: card vs CPU on the same inputs and codes outside the bands: {a}")
    if k3_launches != 2 * 13:
        fail(f"qat: the deploy check launched K3 {k3_launches} times, expected 26")
    if not all(v["cosine"] > QAT_BIND_COSINE and v["close_share"] >= QAT_BIND_SHARE
               for v in deploy.values()):
        fail(f"qat: the fake-quant forward does not bind to the int8 chain: {deploy}")
    return main_launches


def train_at_phase(torch, cuda, sp_state):
    """AT at full width: fixation weights extracted with the trained SP
    over synthetic videos (exact K1/K2 launches per extract batch), then
    TBPTT for 2 epochs with stateful validation, and the carry threaded
    through consecutive windows against one rollout of the whole
    sequence. Returns the AT state dict and the launch counts."""
    from gaze_tpu_torch.core.config import parity_config
    from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.train.at import (build_tbptt_schedule, create_at_state,
                                         fixation_onset_weights, make_at_stateful_eval,
                                         make_at_tbptt_step, split_at_validation)
    from gaze_tpu_torch.train.sp import extract_fixation_weights

    cfg = dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=TRAIN_B, learning_rate=TRAIN_LR))
    per_batch = flow_launches(cfg, 1)
    pipe = GazePipeline(cfg, seed=0)
    dev = pipe.device
    extract = extract_fixation_weights(pipe, sp_state)
    video_w, n_batches, extract_s = [], 0, 0.0
    for v in range(AT_VIDEOS):
        frames, gaze, fixsac = generate_sequence(SyntheticSpec(
            num_frames=AT_FRAMES, height=SIZE, width=SIZE, seed=AT_SEED + v))
        ws = []
        for s in range(1, len(frames), TRAIN_B):
            idx = np.arange(s, min(s + TRAIN_B, len(frames)))
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            t0 = time.perf_counter()
            ws.append(extract({"prev": frames[idx - 1], "cur": frames[idx],
                               "gaze": gaze[idx]}).cpu().numpy())
            extract_s += time.perf_counter() - t0
            if launch_counts(cuda) != per_batch:
                fail(f"train_at: extract batch {n_batches} launched {launch_counts(cuda)}, "
                     f"expected {per_batch}")
            n_batches += 1
        video_w.append(fixation_onset_weights(np.concatenate(ws), fixsac[1:]))
    fixations = [len(w) for w in video_w]
    if min(fixations) < 3 or not all(np.isfinite(w).all() for w in video_w):
        fail(f"train_at: fixation sequences {fixations} (or non-finite weights)")
    train_w, val_w = split_at_validation(video_w)
    schedule = build_tbptt_schedule(train_w, AT_SEQ_LEN, min(TRAIN_B, len(train_w)))
    val_schedule = build_tbptt_schedule(val_w, AT_SEQ_LEN, max(1, min(TRAIN_B, len(val_w))))
    state = create_at_state(pipe)
    step = make_at_tbptt_step(pipe)
    evaluate = make_at_stateful_eval(pipe)
    lanes = schedule[0]["inputs"].shape[0]
    shape = (lanes, cfg.at.num_layers, cfg.at.hidden_size)
    _, prof = device_profile(torch, lambda: extract(
        {"prev": frames[:TRAIN_B], "cur": frames[1:TRAIN_B + 1], "gaze": gaze[1:TRAIN_B + 1]}))
    extract_busy = busy_ms(prof)
    losses, val_mse, step_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(AT_EPOCHS):
        cc = ch = torch.zeros(shape, device=dev)
        for sched in schedule:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, dict(sched, carry_c=cc, carry_h=ch))
            cc, ch = m["carry_c"], m["carry_h"]
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        val_mse.append(evaluate(state.module, val_schedule))
    peak = torch.cuda.max_memory_allocated()
    _, prof = device_profile(torch, lambda: step(state, dict(schedule[0], carry_c=cc,
                                                             carry_h=ch)))
    step_busy = busy_ms(prof)
    # the carry threaded through consecutive windows = one rollout
    lstm = state.module
    seq = torch.from_numpy(max(video_w, key=len)[:-1]).to(dev)[None]
    with torch.no_grad():
        whole_carry, whole = lstm.rollout(lstm.init_carry(1, dev), seq)
        carry, outs = lstm.init_carry(1, dev), []
        for s in range(0, seq.shape[1], AT_SEQ_LEN):
            carry, o = lstm.rollout(carry, seq[:, s:s + AT_SEQ_LEN])
            outs.append(o)
        thread_err = max(float((torch.cat(outs, 1) - whole).abs().max()),
                         max(float((a - b).abs().max())
                             for ca, cb in zip(carry, whole_carry) for a, b in zip(ca, cb)))
    emit("train_at", videos=AT_VIDEOS, frames=AT_FRAMES, size=SIZE, fixations=fixations,
         extract_batches=n_batches, extract_s=extract_s,
         extract_batch_wall_ms=extract_s * 1e3 / n_batches, extract_batch_device_busy_ms=extract_busy,
         extract_idle_share=1 - extract_busy / (extract_s * 1e3 / n_batches),
         launches_per_extract_batch=per_batch,
         seq_len=AT_SEQ_LEN, lanes=lanes, windows_per_epoch=len(schedule), epochs=AT_EPOCHS,
         losses=losses, step_ms=step_ms, step_device_busy_ms=step_busy,
         step_idle_share=1 - step_busy / float(np.median(step_ms)), peak_mem_bytes=peak,
         val_mse=val_mse, threaded_windows=len(outs),
         threaded_vs_rollout_max_diff=thread_err, tol=AT_THREAD_TOL)
    if not all(np.isfinite(losses + val_mse)):
        fail(f"train_at: non-finite losses {losses} or validation {val_mse}")
    if not thread_err <= AT_THREAD_TOL:
        fail(f"train_at: threaded windows differ from one rollout by {thread_err}")
    return ({k: v.detach().clone() for k, v in lstm.state_dict().items()},
            {k: v * n_batches for k, v in per_batch.items()})


def train_lf_phase(torch, cuda, sp_state, at_state):
    """LF at full width on the frozen SP and AT: teacher-forced steps at
    B=8, one rollout step over B=2 clips of T=4, the eval step, a
    checkpoint round trip and the resume check (cuDNN deterministic).
    Returns the launch counts of the steps, the rollout step and the
    eval."""
    import tempfile

    from gaze_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint
    from gaze_tpu_torch.core.config import parity_config
    from gaze_tpu_torch.data.synthetic import SyntheticSpec, clip_iterator
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.train.lf import (create_lf_state, make_lf_eval_step,
                                         make_lf_rollout_train_step, make_lf_train_step)

    cfg = dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=TRAIN_B, learning_rate=TRAIN_LR))
    per_step = flow_launches(cfg, 1)
    frozen = {"sp": sp_state, "at": at_state}
    pipe = GazePipeline(cfg, seed=0)
    batches = sp_batches(cfg, TRAIN_B, LF_STEPS, seed=1)
    state = create_lf_state(pipe)
    step = make_lf_train_step(pipe, frozen)
    losses, walls, total = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if launch_counts(cuda) != per_step:
            fail(f"train_lf: step {i} launched {launch_counts(cuda)}, expected {per_step}")
        total = {k: total.get(k, 0) + v for k, v in launch_counts(cuda).items()}
    peak = torch.cuda.max_memory_allocated()
    _, prof = device_profile(torch, lambda: step(state, batches[-1]))
    busy = busy_ms(prof)
    wall_ms = float(np.median(walls[1:])) * 1e3   # the first builds cuDNN's plans
    clip = next(clip_iterator(SyntheticSpec(num_frames=64, height=SIZE, width=SIZE, seed=2),
                              LF_CLIPS, LF_T, 1, seed=2))
    rstep = make_lf_rollout_train_step(pipe, frozen)
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = rstep(state, clip)
    torch.cuda.synchronize()
    rollout_ms = (time.perf_counter() - t0) * 1e3
    rollout_loss = float(m["loss"])
    want = {k: v * LF_T for k, v in per_step.items()}
    if launch_counts(cuda) != want:
        fail(f"train_lf: rollout step launched {launch_counts(cuda)}, expected {want}")
    total = {k: total[k] + v for k, v in launch_counts(cuda).items()}
    _, prof = device_profile(torch, lambda: rstep(state, clip))
    rollout_busy = busy_ms(prof)
    cuda.reset_launch_counts()
    ev = make_lf_eval_step(pipe, frozen)(state, batches[0])
    if launch_counts(cuda) != per_step:
        fail(f"train_lf: eval step launched {launch_counts(cuda)}, expected {per_step}")
    total = {k: total[k] + v for k, v in launch_counts(cuda).items()}
    aae, auc = ev["aae"].cpu().numpy(), ev["auc"].cpu().numpy()

    def snap(st):
        return ([v.detach().clone() for v in st.module.state_dict().values()]
                + [t.clone() for t in st.opt_state.mu + st.opt_state.nu],
                (st.step, st.opt_state.count))

    def same(x, y):
        return x[1] == y[1] and all(torch.equal(a, b) for a, b in zip(x[0], y[0]))

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lf_") as d:
        before = snap(state)
        save_checkpoint(d + "/rt", state.step, state)
        other = create_lf_state(pipe, seed=7)
        restore_checkpoint(d + "/rt", other)
        round_trip = same(snap(other), before)
        # resume: 2 steps + save + restore + 2 steps = 4 steps, bit for bit
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            st = create_lf_state(pipe)
            for batch in batches[:4]:
                st, _ = step(st, batch)
            straight = snap(st)
            st = create_lf_state(pipe)
            for batch in batches[:2]:
                st, _ = step(st, batch)
            save_checkpoint(d + "/resume", st.step, st)
            st = create_lf_state(pipe, seed=7)
            restore_checkpoint(d + "/resume", st)
            for batch in batches[2:4]:
                st, _ = step(st, batch)
            resumed = same(snap(st), straight)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    emit("train_lf", batch=TRAIN_B, size=SIZE, channels=list(cfg.lf.channels), steps=LF_STEPS,
         step_wall_ms=[w * 1e3 for w in walls], step_wall_ms_median=wall_ms,
         step_device_busy_ms=busy, device_idle_share=1 - busy / wall_ms, peak_mem_bytes=peak,
         losses=losses, launches_per_step=per_step, launches=total,
         rollout={"clips": LF_CLIPS, "frames": LF_T, "loss": rollout_loss,
                  "wall_ms": rollout_ms, "device_busy_ms": rollout_busy,
                  "idle_share": 1 - rollout_busy / rollout_ms, "launches": want},
         eval_mean_aae_deg=float(aae.mean()), eval_mean_auc=float(auc.mean()),
         checkpoint_round_trip_bit_equal=round_trip, resume_bit_equal=resumed,
         resume_cudnn_deterministic=True)
    if not all(np.isfinite(losses + [rollout_loss])) or not np.isfinite(aae).all():
        fail(f"train_lf: non-finite losses {losses}, {rollout_loss} or AAE {aae}")
    if not round_trip:
        fail("train_lf: a checkpoint round trip changed the state")
    if not resumed:
        fail("train_lf: 2 steps + save + restore + 2 steps differ from 4 steps")
    return total


def stages_phase(torch, cuda):
    """The trainer end to end at full width: SP -> AT -> LF, 1 epoch of 2
    steps at B=4 each, into a temporary directory removed afterwards;
    then the restored best weights in a fresh GazePipeline run a rollout
    evaluation over 2 videos. Returns the launch counts of the stages."""
    import contextlib
    import io
    import shutil
    import tempfile

    from gaze_tpu_torch.core.checkpoint import best_metric, latest_step
    from gaze_tpu_torch.core.config import parity_config
    from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
    from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.models.qat import SCALES_FILE
    from gaze_tpu_torch.train.stages import (StageOptions, run_train_late, run_train_lstm,
                                             run_train_qat, run_train_sp)

    cfg = dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=STAGE_B, learning_rate=TRAIN_LR))
    d = tempfile.mkdtemp(prefix="chip_smoke_stages_")
    try:
        pipe = GazePipeline(cfg, seed=0)
        opts = StageOptions(batch_size=STAGE_B, epochs=1, steps_per_epoch=STAGE_STEPS,
                            save_dir=d, log_every=1)
        log = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            sp = run_train_sp(opts, pipe)
            t_sp = time.perf_counter() - t0
            sp = run_train_qat(opts, pipe, sp)
            t_qat = time.perf_counter() - t0 - t_sp
            at = run_train_lstm(opts, pipe, sp)
            t_at = time.perf_counter() - t0 - t_sp - t_qat
            lf = run_train_late(opts, pipe, sp, at)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts(cuda)
        # preprocess_pair calls: SP 2 steps + 1 validation; QAT its
        # calibration pairs (the epoch's 2 batches), 2 steps + 1
        # validation; AT one per extract batch of the 64-frame video; LF 2
        # steps + 1 validation
        calls = (STAGE_STEPS + 1) + (2 * STAGE_STEPS + 1) + -(-(64 - 1) // STAGE_B) \
            + (STAGE_STEPS + 1)
        want = flow_launches(cfg, calls)
        if launches != want:
            fail(f"stages: kernel launches {launches}, expected {want}")
        saved = {name: (latest_step(f"{d}/{name}"), best_metric(f"{d}/{name}"))
                 for name in ("sp", "sp_qat", "at", "lf")}
        if not all(s is not None and m is not None for s, m in saved.values()):
            fail(f"stages: missing checkpoints or best metrics {saved}")
        if not os.path.exists(os.path.join(d, "sp_qat", SCALES_FILE)):
            fail(f"stages: run_train_qat wrote no {SCALES_FILE}")
        lines = [json.loads(x) for x in log.getvalue().splitlines() if x.startswith("{")]
        evalp = GazePipeline(cfg, seed=1)
        evalp.load_state_dicts({"sp": sp, "at": at, "lf": lf.module.state_dict()})
        seqs = [generate_sequence(SyntheticSpec(num_frames=STAGE_ROLL_T, height=SIZE,
                                                width=SIZE, seed=2000 + v)) for v in range(2)]
        frames, gaze, fixsac = (np.stack(x) for x in zip(*seqs))
        sums = rollout_eval_arrays(evalp, frames, gaze, fixsac, chunk_len=STAGE_ROLL_T)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit("stages", batch=STAGE_B, epochs=1, steps_per_epoch=STAGE_STEPS, size=SIZE,
         seconds=secs, sp_s=t_sp, qat_s=t_qat, at_s=t_at, lf_s=secs - t_sp - t_qat - t_at,
         peak_mem_bytes=peak,
         checkpoints={k: {"latest_step": s, "best_metric": m} for k, (s, m) in saved.items()},
         log_lines=len(lines), final_losses={x["stage"]: x["loss"] for x in lines if "loss" in x},
         launches=launches, rollout_videos=2, rollout_frames=STAGE_ROLL_T,
         rollout_sums=[s.tolist() for s in sums], temp_dir_removed=not os.path.exists(d))
    if not all(np.isfinite(s).all() for s in sums) or sums[2].tolist() != [STAGE_ROLL_T - 1] * 2:
        fail(f"stages: rollout sums {sums}")
    if os.path.exists(d):
        fail(f"stages: {d} was not removed")
    return launches


# ------------------------------------------------------------ data layer ----
class PerCall:
    """While active, ``module.<factory>`` is wrapped so that every function
    it makes records the kernel launches of each of its calls (a list of
    {kernel: launches} in ``calls``)."""

    def __init__(self, cuda, module, factory: str):
        self.cuda, self.module, self.factory = cuda, module, factory
        self.orig = getattr(module, factory)
        self.calls = []

    def __enter__(self):
        def make(*args, **kw):
            fn = self.orig(*args, **kw)

            def run(*a, **k):
                before = launch_counts(self.cuda)
                out = fn(*a, **k)
                after = launch_counts(self.cuda)
                self.calls.append({n: after[n] - before[n] for n in after})
                return out

            return run

        setattr(self.module, self.factory, make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.factory, self.orig)
        return False


def gtea_video(rng, n: int, hw):
    """(n, H, W, 3) uint8 frames of one video: three textures (one per
    channel) on a canvas 2n pixels wider on each side, cropped along an
    integer random walk of up to 2 px a frame."""
    H, W = hw
    pad = 2 * n
    canvas = textures(rng, 3, H + 2 * pad, W + 2 * pad, waves=4)()
    steps = rng.integers(-2, 3, (n, 2))
    steps[0] = 0
    out = np.empty((n, H, W, 3), np.uint8)
    for t, (dy, dx) in enumerate(np.cumsum(steps, axis=0) + pad):
        out[t] = np.round(canvas[:, dy:dy + H, dx:dx + W].transpose(1, 2, 0) * 255)
    return out


def gtea_gaze(rng, n: int, hw, untracked):
    """(gaze txt lines, fixsac bits) of one video in native pixels: the
    gaze dwells 3-6 frames (a fixation, its first frame the saccade that
    lands it) and jumps; the frames in ``untracked`` get "nan nan", the
    tracker's "0 0" sentinel and a point past the frame, in turn."""
    H, W = hw
    rows, bits = [], []
    while len(rows) < n:
        x, y = rng.uniform(20, W - 20), rng.uniform(20, H - 20)
        for k in range(int(rng.integers(3, 7))):
            rows.append(f"{x + rng.uniform(-2, 2):.2f} {y + rng.uniform(-2, 2):.2f}")
            bits.append(int(k > 0))
    rows, bits = rows[:n], bits[:n]
    for k, t in enumerate(untracked):
        rows[t] = ("nan nan", "0 0", f"{W + 10} {H / 2}")[k % 3]
    return rows, bits


def dataset_phase(torch, cuda, root: str, rng):
    """A GTEA tree of DATA_V videos of DATA_T frames at the native grid,
    written with the port's image writer (cv2, else PIL), one more video
    through an MJPEG AVI and ``extract_dataset``; the codec route, the
    encode and decode ms per frame, and the decode held to the source
    frames (PSNR). Returns the video names and the manifest."""
    from gaze_tpu_torch.data import flow_extract, native_io
    from gaze_tpu_torch.data.gtea import build_manifest
    from gaze_tpu_torch.data.video import extract_dataset, ffmpeg_path, write_mjpeg_avi

    cuda.reset_launch_counts()
    H, W = DATA_HW
    names = [f"{DATA_SUBJECTS[v // 2]}_Video{v}" for v in range(DATA_V)] + [DATA_AVI]
    for d in ("images", "gaze", "fixsac", "videos", "avi_frames"):
        os.makedirs(os.path.join(root, d))
    encode_s, sources, untracked_rows = 0.0, {}, 0
    for v, name in enumerate(names):
        frames = gtea_video(rng, DATA_T, DATA_HW)
        sources[name] = frames
        avi = name == DATA_AVI
        fdir = os.path.join(root, "avi_frames" if avi else os.path.join("images", name))
        os.makedirs(fdir, exist_ok=True)
        t0 = time.perf_counter()
        for t, img in enumerate(frames):
            flow_extract._imwrite(img, os.path.join(fdir, f"{t + avi:06d}.jpg"), DATA_QUALITY)
        encode_s += time.perf_counter() - t0
        bad = DATA_UNTRACKED if v % 2 else ()
        rows, bits = gtea_gaze(rng, DATA_T, DATA_HW, bad)
        untracked_rows += len(bad) if v != DATA_V - 1 else 0
        if v != DATA_V - 1:   # the last video of the tree has no gaze txt
            with open(os.path.join(root, "gaze", name + ".txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
        if v < DATA_FIXSAC:
            with open(os.path.join(root, "fixsac", name + ".txt"), "w") as f:
                f.write("".join(f"{b}\n" for b in bits))
    # the AVI video: its JPEGs into an MJPEG AVI, demuxed back into images/
    adir = os.path.join(root, "avi_frames")
    jpegs = [open(os.path.join(adir, n), "rb").read() for n in sorted(os.listdir(adir))]
    write_mjpeg_avi(os.path.join(root, "videos", DATA_AVI + ".avi"), jpegs, W, H)
    t0 = time.perf_counter()
    got = extract_dataset(os.path.join(root, "videos"), os.path.join(root, "images"))
    demux_s = time.perf_counter() - t0
    idir = os.path.join(root, "images", DATA_AVI)
    stream_copy = ffmpeg_path() is None
    same = [open(os.path.join(idir, n), "rb").read() for n in sorted(os.listdir(idir))] == jpegs
    shutil.rmtree(adir)

    m = build_manifest(root, native_hw=DATA_HW)
    paths = [r.image_path for r in m.frames[names[0]]]
    decode_batch = native_io.decode_batch
    decode_batch(paths[:2])   # builds the library where it can
    t0 = time.perf_counter()
    dec = decode_batch(paths)
    decode_s = time.perf_counter() - t0
    mse = ((dec.astype(np.float64) - sources[names[0]]) ** 2).mean(axis=(1, 2, 3))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    invalid = {v: sum(not r.gaze_valid for r in m.frames[v]) for v in m.videos}
    fixations = {v: int(sum(r.fixation for r in m.frames[v])) for v in m.videos}
    if native_io.native_available():
        decoder = "libjpeg, gaze_tpu_torch/csrc/gaze_io.cpp"
    else:
        import PIL

        decoder = f"PIL {PIL.__version__}"
    cv2 = flow_extract._cv2()
    route = {"decode": decoder, "encode": f"cv2 {cv2.__version__}" if cv2 is not None else "PIL",
             "video": "stream-copy MJPEG-AVI demux" if stream_copy else "ffmpeg"}
    emit("dataset", videos=len(names), frames=DATA_T, hw=list(DATA_HW), quality=DATA_QUALITY,
         codec_route=route, encode_ms_per_frame=encode_s * 1e3 / (len(names) * DATA_T),
         decode_ms_per_frame=decode_s * 1e3 / len(paths), decode_batch_frames=len(paths),
         decode_psnr_db_min=float(psnr.min()), decode_psnr_db_mean=float(psnr.mean()),
         avi_frames=got.get(DATA_AVI), avi_demux_s=demux_s, avi_payloads_equal=same,
         untracked_frames=invalid, fixation_frames=fixations,
         launches=launch_counts(cuda))
    if got != {DATA_AVI: DATA_T} or (stream_copy and not same):
        fail(f"dataset: the AVI came back as {got} (payloads equal: {same})")
    if m.videos != sorted(names) or any(len(m.frames[v]) != DATA_T for v in names):
        fail(f"dataset: manifest videos {m.videos}")
    if invalid[names[DATA_V - 1]] != DATA_T or sum(
            invalid[v] for v in names if v != names[DATA_V - 1]) != untracked_rows:
        fail(f"dataset: untracked frames {invalid}, expected {untracked_rows} and all of "
             f"{names[DATA_V - 1]}")
    if not psnr.min() >= DATA_PSNR_MIN:
        fail(f"dataset: decoded frames {psnr.min()} dB from their sources < {DATA_PSNR_MIN}")
    if any(launch_counts(cuda).values()):
        fail(f"dataset: kernels launched {launch_counts(cuda)}")
    return names


def k2_dense_flow_levels(torch, dev, t1):
    """K2 at every pyramid level of the dense_flow preset at the native
    grid, B=EXTRACT_B: 30 iterations and 2 fused median passes per call,
    held bit-equal to its plain version, timed, with its bound."""
    from gaze_tpu_torch.ops.cuda import tvl1_pd
    from gaze_tpu_torch.ops.image import central_gradient
    from gaze_tpu_torch.ops.tvl1 import _median_passes, _pyramid_shapes

    passes = _median_passes(t1)
    kw = dict(iters=t1.iters, tau=t1.tau, lambda_=t1.lambda_, theta=t1.theta)
    rows = []
    for lvl, (h, w) in enumerate(_pyramid_shapes(*DATA_HW, t1.pyramid_levels,
                                                 t1.pyramid_factor)):
        gen = torch.Generator(device=dev).manual_seed(lvl)
        shape = (EXTRACT_B, h, w)

        def uniform(lo, hi):
            return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

        yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
        xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
        i1 = 127 + 100 * torch.sin(xx / 7 + uniform(0, 0.2)) * torch.cos(yy / 11)
        i1wx, i1wy = (g.contiguous() for g in central_gradient(i1))
        grad = i1wx * i1wx + i1wy * i1wy
        p = [uniform(-0.5, 0.5) for _ in range(4)]
        for j in (0, 2):
            p[j][:, :, -1] = 0   # x-duals zero in the last column
            p[j + 1][:, -1, :] = 0   # y-duals zero in the last row
        args = (uniform(-2, 2), uniform(-2, 2), *p, i1wx, i1wy, grad, uniform(-40, 40))
        before = tvl1_pd.KERNEL.launches
        got = tvl1_pd.pd_iterations(*args, median_passes=passes, **kw)
        per_call = tvl1_pd.KERNEL.launches - before
        ref = k2_plain(args, kw, passes)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, r) for g, r in zip(got, ref))
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        del ref
        ms = cuda_ms(torch, lambda: tvl1_pd.pd_iterations(*args, median_passes=passes, **kw),
                     3, 1)
        _, prof = device_profile(
            torch, lambda: [tvl1_pd.pd_iterations(*args, median_passes=passes, **kw)
                            for _ in range(2)])
        dev_us, dev_n = device_us(prof, "pd_iterations_kernel")
        traced = sorted(prof.items(), key=lambda kv: -kv[1][0])[:4]
        nbytes = 16 * 4 * EXTRACT_B * h * w
        flops = (K2_FLOPS_PER_PIXEL_ITER * t1.iters + K2_OPS_PER_PIXEL_MEDIAN * passes) \
            * EXTRACT_B * h * w
        rows.append({"level": lvl, "shape": list(shape), "iters": t1.iters,
                     "median_passes": passes, "bitwise_equal": equal, "max_abs_err": err,
                     "launches_per_call": per_call, "ms": ms,
                     "device_ms": dev_us / dev_n / 1e3 if dev_n else None,
                     "traced": [[k[:60], v[0] / 1e3, v[1]] for k, v in traced],
                     "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
                     "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
                     else "operations"})
        del args, got, p, i1, i1wx, i1wy, grad
        if not equal or per_call != 1:
            fail(f"extract: K2 at {shape}: bitwise equal {equal} (max abs {err}), "
                 f"{per_call} launches per call")
    torch.cuda.empty_cache()
    return rows


def extract_phase(torch, dev, cuda, root: str, names):
    """``extract_flow_images`` on the card under the dense_flow preset at
    the native grid, windows of EXTRACT_B pairs, half the videos in the
    x/y layout and half packed: exact K1 and K2 launches per window, one
    window held to the plain path (codes equal), pairs/s, K2 per level.
    Returns the launch counts of the extraction."""
    import dataclasses as dc

    from gaze_tpu_torch.core.config import TVL1Config, dense_flow_tvl1_config
    from gaze_tpu_torch.data import flow_extract
    from gaze_tpu_torch.data.native_io import decode_batch
    from gaze_tpu_torch.ops.tvl1 import _pyramid_shapes

    t1 = dense_flow_tvl1_config()
    bound = TVL1Config().quant_bound
    levels = len(_pyramid_shapes(*DATA_HW, t1.pyramid_levels, t1.pyramid_factor))
    per_window = {"warp3": levels * t1.warps, "tvl1_pd": levels * t1.warps, "conv3x3_int8": 0}
    layouts = {"xy": names[0::2], "packed": names[1::2]}
    windows_want = len(names) * -(-(DATA_T - 1) // EXTRACT_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    written = {}
    t0 = time.perf_counter()
    with PerCall(cuda, flow_extract, "make_flow_quant_fn") as windows:
        for layout, vids in layouts.items():
            spec = flow_extract.FlowExtractSpec(tvl1=t1, bound=bound, layout=layout,
                                                batch_size=EXTRACT_B, flow_scale=1.0)
            written[layout] = flow_extract.extract_flow_images(root, spec, videos=vids,
                                                               verbose=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts(cuda)
    pairs = sum(written.values())
    bad = [c for c in windows.calls if c != per_window]
    if bad or len(windows.calls) != windows_want or pairs != len(names) * (DATA_T - 1):
        fail(f"extract: {len(windows.calls)} windows (expected {windows_want}), {pairs} flow "
             f"images, launches per window {windows.calls}, expected {per_window}")

    # one window again, kernels against the plain path, on the card
    paths = [os.path.join(root, "images", names[0], n)
             for n in sorted(os.listdir(os.path.join(root, "images", names[0])))]
    w = torch.from_numpy(decode_batch(paths[:EXTRACT_B + 1])).to(dev)
    spec = flow_extract.FlowExtractSpec(tvl1=t1, bound=bound, batch_size=EXTRACT_B)
    plain = dc.replace(spec, tvl1=dc.replace(t1, use_pallas_warp=False, use_pallas_pd=False))
    codes = {}
    for name, s in (("kernels", spec), ("plain", plain)):
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        codes[name] = flow_extract.make_flow_quant_fn(s, DATA_HW, dev)(w[:-1], w[1:])
        torch.cuda.synchronize()
        codes[name + "_s"] = time.perf_counter() - t0
        codes[name + "_launches"] = launch_counts(cuda)
    diff = (codes["kernels"].int() - codes["plain"].int()).abs()
    equal = bool(torch.equal(codes["kernels"], codes["plain"]))
    spread = int(torch.unique(codes["kernels"]).numel())
    del w, codes["kernels"], codes["plain"]
    torch.cuda.empty_cache()
    k2_levels = k2_dense_flow_levels(torch, dev, t1)
    emit("extract", preset="dense_flow", tvl1=dc.asdict(t1), bound=bound, batch=EXTRACT_B,
         flow_scale=1.0, hw=list(DATA_HW), layouts={k: len(v) for k, v in layouts.items()},
         fmt=spec.fmt, flow_images=written, windows=len(windows.calls),
         launches_per_window=per_window, launches=launches, seconds=wall,
         pairs_per_s=pairs / wall, peak_mem_bytes=peak,
         plain_window={"codes_equal": equal, "max_code_diff": int(diff.max()),
                       "distinct_codes": spread, "kernel_path_s": codes["kernels_s"],
                       "plain_path_s": codes["plain_s"],
                       "kernel_launches": codes["kernels_launches"],
                       "plain_launches": codes["plain_launches"]},
         k2_by_level=k2_levels)
    if not equal or any(codes["plain_launches"].values()) \
            or codes["kernels_launches"] != per_window:
        fail(f"extract: the kernel path's codes differ from the plain path's (max "
             f"{int(diff.max())}) or the launches are wrong: {codes}")
    return launches, k2_levels


def card_vs_cpu_bands(torch, cfg, hm_g, gz_g, hm_c, gz_c, gaze, valid):
    """Bands on the AAE and AUC sums of one video's scored frames, from the
    card's and the CPU's per-frame outputs (``run_clip``): AAE by the angle
    between the two gazes, AUC by the pixels whose order against the GT
    pixel a heatmap difference of delta can flip (within 2 delta of its
    value), over H*W; each plus the per-frame tolerance. Frame t of the
    outputs scores gaze[t + 1]; frames whose ``valid`` is 0 score nothing.
    Returns (AAE band, AUC band, near-tie frames, mismatched frames, delta)."""
    from gaze_tpu_torch.evaluation.metrics import pixel_to_ray

    H, W = cfg.image.height, cfg.image.width
    delta = float((hm_g - hm_c).abs().max())
    aae_band = auc_band = 0.0
    for t in range(gz_g.shape[1]):
        if not valid[t + 1]:
            continue
        rays = pixel_to_ray(torch.stack([gz_g[0, t], gz_c[0, t]]), (H, W), cfg.camera)
        chord = float((rays[0] - rays[1]).norm())
        aae_band += float(np.degrees(2 * np.arcsin(min(chord / 2, 1.0)))) + ROLL_AAE_TOL
        gx = int(np.clip(np.round(gaze[t + 1][0]), 0, W - 1))
        gy = int(np.clip(np.round(gaze[t + 1][1]), 0, H - 1))
        close = int(((hm_c[0, t] - hm_c[0, t, gy, gx]).abs() <= 2 * delta).sum())
        auc_band += close / (H * W) + ROLL_AUC_TOL
    ties, mismatched = near_ties(hm_c, gz_c, gz_g, max(NEAR_TIE, 2 * delta))
    return aae_band, auc_band, ties, mismatched, delta


def videos_phase(torch, cuda, turbo, root: str, names):
    """``rollout_eval_videos`` with the turbo pipeline over the tree, in
    groups of VIDEO_GROUP: (a) TV-L1 on the frames at chunks of 8 and 16
    (results equal), (b) the extracted flow images (no K1/K2); exact
    launches per chunk; one video's first frames held to a CPU run.
    Returns the launch counts of (a) at chunks of 8 and of (b)."""
    from gaze_tpu_torch.data.gtea import build_manifest
    from gaze_tpu_torch.data.native_io import decode_batch
    from gaze_tpu_torch.evaluation import rollout
    from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip

    pipe, cfg = turbo["pipe"], turbo["cfg"]
    recs = build_manifest(root, native_hw=DATA_HW).frames
    groups = [sorted(recs)[g:g + VIDEO_GROUP] for g in range(0, len(recs), VIDEO_GROUP)]

    def steps(chunk_len):   # the pipeline steps of a run: chunks are padded
        return sum(-(-(max(len(recs[v]) for v in g) - 1) // chunk_len) * chunk_len
                   for g in groups)

    runs = {}
    for flow, chunk_len in ((False, VIDEO_CHUNKS[0]), (False, VIDEO_CHUNKS[1]),
                            (True, VIDEO_CHUNKS[0])):
        per_chunk = {k: v * chunk_len for k, v in turbo["per_step"].items()}
        if flow:
            per_chunk.update(warp3=0, tvl1_pd=0)
        waits = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with PerCall(cuda, rollout, "make_rollout_chunk_fn") as chunks:
            res = rollout.rollout_eval_videos(pipe, recs, chunk_len=chunk_len,
                                              group_size=VIDEO_GROUP,
                                              use_precomputed_flow=flow, decode_waits=waits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_chunks = steps(chunk_len) // chunk_len
        runs[(flow, chunk_len)] = dict(
            results=res, seconds=wall, launches=launch_counts(cuda),
            peak=torch.cuda.max_memory_allocated(), waits=waits, chunks=len(chunks.calls))
        if [c for c in chunks.calls if c != per_chunk] or len(chunks.calls) != n_chunks:
            fail(f"videos flow={flow} chunk_len={chunk_len}: {len(chunks.calls)} chunks "
                 f"(expected {n_chunks}), launches per chunk {chunks.calls}, "
                 f"expected {per_chunk}")
    a8, a16, b8 = (runs[k] for k in ((False, VIDEO_CHUNKS[0]), (False, VIDEO_CHUNKS[1]),
                                     (True, VIDEO_CHUNKS[0])))
    if a8["results"] != a16["results"]:
        fail(f"videos: the results at chunk_len {VIDEO_CHUNKS[0]} differ from those at "
             f"{VIDEO_CHUNKS[1]}: {a8['results']} vs {a16['results']}")
    want_counts = {v: sum(r.gaze_valid for r in recs[v][1:]) for v in recs}
    for key, r in runs.items():
        counts = {v: x[2] for v, x in r["results"].items()}
        if counts != want_counts or not all(np.isfinite(x[:2]).all()
                                            for x in r["results"].values()):
            fail(f"videos {key}: results {r['results']}, expected counts {want_counts}")
    # the device's busy time over the TV-L1 run at chunks of 8
    _, prof = device_profile(torch, lambda: rollout.rollout_eval_videos(
        pipe, recs, chunk_len=VIDEO_CHUNKS[0], group_size=VIDEO_GROUP,
        use_precomputed_flow=False))
    busy = busy_ms(prof) / 1e3

    # video 0's first frames on the card and on the CPU, same weights and
    # calibration, bands from the two runs' per-frame outputs
    v0, n = names[0], VIDEO_CPU_FRAMES
    sub = {v0: recs[v0][:n]}
    cpu = GazePipeline(cfg, dtype=turbo["dtype"], device="cpu", quant_sp=turbo["qsp"])
    cpu.load_state_dicts(turbo["weights"])
    card = rollout.rollout_eval_videos(pipe, sub, chunk_len=n - 1, group_size=1,
                                       use_precomputed_flow=False)[v0]
    t0 = time.perf_counter()
    on_cpu = rollout.rollout_eval_videos(cpu, sub, chunk_len=n - 1, group_size=1,
                                         use_precomputed_flow=False)[v0]
    cpu_s = time.perf_counter() - t0
    frames = decode_batch([r.image_path for r in sub[v0]])[None]
    fix = np.array([[r.fixation for r in sub[v0]]], np.float32)
    sx, sy = cfg.image.width / DATA_HW[1], cfg.image.height / DATA_HW[0]
    gaze = np.array([(r.gaze[0] * sx, r.gaze[1] * sy) for r in sub[v0]], np.float32)
    valid = [r.gaze_valid for r in sub[v0]]
    hm_g, gz_g = (x.float().cpu() for x in run_clip(pipe, frames, fix))
    hm_c, gz_c = (x.float() for x in run_clip(cpu, frames, fix))
    aae_band, auc_band, ties, mismatched, delta = card_vs_cpu_bands(
        torch, cfg, hm_g, gz_g, hm_c, gz_c, gaze, valid)
    d_aae = abs(card[0] * card[2] - on_cpu[0] * on_cpu[2])
    d_auc = abs(card[1] * card[2] - on_cpu[1] * on_cpu[2])
    scored = {k: sum(x[2] for x in r["results"].values()) for k, r in runs.items()}
    decoded = sum(len(recs[v]) for v in recs)
    emit("videos", videos=len(recs), frames=DATA_T, hw=list(DATA_HW), group=VIDEO_GROUP,
         chunk_lens=list(VIDEO_CHUNKS),
         runs=[{"flow_images": f, "chunk_len": c, "seconds": r["seconds"],
                "frames_per_s": scored[(f, c)] / r["seconds"],
                "decoded_frames_per_s": decoded / r["seconds"], "chunks": r["chunks"],
                "decode_wait_ms_per_chunk": [w * 1e3 for w in r["waits"]],
                "decode_wait_share": sum(r["waits"]) / r["seconds"],
                "peak_mem_bytes": r["peak"], "launches": r["launches"]}
               for (f, c), r in runs.items()],
         device_busy_s=busy, device_idle_share=1 - busy / a8["seconds"],
         mean_aae_deg=float(np.mean([x[0] for x in a8["results"].values() if x[2]])),
         mean_auc=float(np.mean([x[1] for x in a8["results"].values() if x[2]])),
         counts={v: x[2] for v, x in a8["results"].items()},
         flow_images_mean_aae_deg=float(np.mean([x[0] for x in b8["results"].values()
                                                 if x[2]])),
         cpu_frames=n, cpu_s=cpu_s, cpu_count=on_cpu[2], cpu_aae_sum_diff=d_aae,
         cpu_aae_band=aae_band, cpu_auc_sum_diff=d_auc, cpu_auc_band=auc_band,
         cpu_heatmap_max_diff=delta, cpu_near_tie_frames=ties)
    if mismatched:
        fail(f"videos: the card's gaze differs from the CPU run's at {mismatched}")
    if card[2] != on_cpu[2] or not (d_aae <= aae_band and d_auc <= auc_band):
        fail(f"videos: card vs CPU: count {card[2]} vs {on_cpu[2]}, AAE sum {d_aae} (band "
             f"{aae_band}), AUC sum {d_auc} (band {auc_band})")
    return a8["launches"], b8["launches"]


def data_stages_phase(torch, cuda, root: str):
    """The trainer on the tree at full width (parity preset), B=DATA_STAGE_B,
    1 epoch, DATA_SUBJECTS[-1] held out: the SP stage with
    ``precomputed_flow="off"`` (K1/K2 in every step, exact launches per
    step), then SP -> AT -> LF with "auto" (the flow images: no K1/K2).
    Returns the launch counts of both runs."""
    import tempfile

    from gaze_tpu_torch.core.checkpoint import best_metric, latest_step
    from gaze_tpu_torch.core.config import parity_config
    from gaze_tpu_torch.data.gtea import build_manifest
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.train import stages

    cfg = dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=DATA_STAGE_B, learning_rate=TRAIN_LR))
    held = DATA_SUBJECTS[-1]
    m = build_manifest(root, native_hw=DATA_HW)
    train, test = m.split_leave_one_out(held)
    pairs = sum(len(m.frames[v]) - 1 for v in m.videos if not v.startswith(held + "_"))
    sp_steps = pairs // DATA_STAGE_B
    per_step = flow_launches(cfg, 1)
    d = tempfile.mkdtemp(prefix="chip_smoke_data_stages_")
    out = {}
    try:
        log = io.StringIO()
        for mode in ("off", "auto"):
            pipe = GazePipeline(cfg, seed=0)
            opts = stages.StageOptions(batch_size=DATA_STAGE_B, epochs=1, log_every=1,
                                       save_dir=os.path.join(d, mode), data_root=root,
                                       test_subject=held, precomputed_flow=mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launch_counts()
            t = {}
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log), \
                    PerCall(cuda, stages, "make_sp_train_step") as sp_steps_seen:
                sp = stages.run_train_sp(opts, pipe)
                torch.cuda.synchronize()
                t["sp"] = time.perf_counter() - t0
                if mode == "auto":
                    at = stages.run_train_lstm(opts, pipe, sp)
                    torch.cuda.synchronize()
                    t["at"] = time.perf_counter() - t0 - t["sp"]
                    stages.run_train_late(opts, pipe, sp, at)
                    torch.cuda.synchronize()
                    t["lf"] = time.perf_counter() - t0 - t["sp"] - t["at"]
            launches = launch_counts(cuda)
            saved = {name: (latest_step(os.path.join(d, mode, name)),
                            best_metric(os.path.join(d, mode, name)))
                     for name in (("sp",) if mode == "off" else ("sp", "at", "lf"))}
            out[mode] = dict(seconds=t, launches=launches, steps=len(sp_steps_seen.calls),
                             peak=torch.cuda.max_memory_allocated(), saved=saved)
            del pipe
            # off: each step's K1/K2, plus the stage-end validation batch;
            # auto: every batch carries flow images, nothing is solved
            want = flow_launches(cfg, sp_steps + 1) if mode == "off" else \
                {k: 0 for k in per_step}
            if launches != want or len(sp_steps_seen.calls) != sp_steps or (
                    mode == "off" and [c for c in sp_steps_seen.calls if c != per_step]):
                fail(f"data_stages {mode}: {len(sp_steps_seen.calls)} SP steps (expected "
                     f"{sp_steps}), launches {launches} (expected {want}), per step "
                     f"{sp_steps_seen.calls}")
            if not all(s is not None and b is not None for s, b in saved.values()):
                fail(f"data_stages {mode}: missing checkpoints or best metrics {saved}")
        lines = [json.loads(x) for x in log.getvalue().splitlines() if x.startswith("{")]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    losses = [x["loss"] for x in lines if "loss" in x]
    emit("data_stages", batch=DATA_STAGE_B, epochs=1, held_out=held,
         train_videos=len({r.video for r in train}), test_videos=len({r.video for r in test}),
         sp_steps=sp_steps, launches_per_sp_step_off=per_step,
         runs={k: {"seconds": v["seconds"], "launches": v["launches"], "sp_steps": v["steps"],
                   "sp_s_per_step": v["seconds"]["sp"] / max(v["steps"], 1),
                   "peak_mem_bytes": v["peak"],
                   "checkpoints": {n: {"latest_step": s, "best_metric": b}
                                   for n, (s, b) in v["saved"].items()}}
               for k, v in out.items()},
         log_lines=len(lines), first_loss=losses[0] if losses else None,
         last_losses={x["stage"]: x["loss"] for x in lines if "loss" in x},
         temp_dir_removed=not os.path.exists(d))
    if not losses or not np.isfinite(losses).all():
        fail(f"data_stages: losses {losses[:5]}...")
    if os.path.exists(d):
        fail(f"data_stages: {d} was not removed")
    return out["off"]["launches"], out["auto"]["launches"]


def dp_config():
    """train_sp's configuration: parity preset, f32, B=8, lr 1e-4."""
    from gaze_tpu_torch.core.config import parity_config

    return dataclasses.replace(parity_config(), train=dataclasses.replace(
        parity_config().train, batch_size=TRAIN_B, learning_rate=TRAIN_LR))


def state_snapshot(state):
    """A TrainState's module state dict and optimizer moments, on the host."""
    return ({k: v.detach().cpu().clone() for k, v in state.module.state_dict().items()},
            [t.detach().cpu().clone() for t in state.opt_state.mu + state.opt_state.nu])


def capture_grads(state, into: list):
    """``state`` with every update recording the gradient it applies
    (the all-reduced one under a mesh) into ``into``, one list per step,
    on the card."""
    apply = state.apply_gradients

    def capturing(grads, new_batch_stats=None):
        into.append([g.detach().clone() for g in grads])
        return apply(grads, new_batch_stats)

    state.apply_gradients = capturing
    return state


def dp_compare(got, want, losses_got, losses_want, grads_got, grads_want, names):
    """Two runs of the same steps from the same state, given the state
    snapshots, losses and applied gradients of each step. Held: the
    first step's gradient (model relative L2, as grad_compare) and
    BatchNorm statistics (as stats_rel_err), which both runs compute at
    the same parameters on the same rows; every step's loss (relative);
    the parameters after the last step (2 lr per step). Later steps'
    gradients and statistics are reported: they are computed at
    parameters that Adam's sign test has already moved by +-lr wherever
    a gradient lies in float32 noise."""
    steps = len(got)
    (sd_g, _), (sd_w, _) = got[-1], want[-1]
    stats = [k for k in sd_w if k.endswith((".running_mean", ".running_var"))]
    params = [k for k in sd_w if k not in stats and sd_w[k].is_floating_point()]
    grads = [grad_compare(g, w, names) for g, w in zip(grads_got, grads_want)]
    out = {"grad_rel_l2_by_step": [g["model_rel_l2"] for g in grads],
           "grad_elem_rel_max_by_step": [g["elem_rel_max"] for g in grads],
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses_got, losses_want)),
           "params_max_abs_diff": max(float((sd_g[k] - sd_w[k]).abs().max()) for k in params),
           "params_abs_band": 2 * TRAIN_LR * steps + 1e-6}
    if stats:
        out["batch_stats_rel_err_by_step"] = [
            stats_rel_err({k: g[0][k] for k in stats}, {k: w[0][k] for k in stats})
            for g, w in zip(got, want)]
    out["ok"] = (len(grads) == steps
                 and out["grad_rel_l2_by_step"][0] <= TRAIN_GRAD_RTOL
                 and out["loss_rel_err"] <= DP_LOSS_RTOL
                 and out["params_max_abs_diff"] <= out["params_abs_band"]
                 and out.get("batch_stats_rel_err_by_step", [0.0])[0] <= TRAIN_STATS_RTOL)
    return out


def dist_init_phase(torch, rendezvous: str):
    """World size 1 over NCCL: the port's global mesh on this card."""
    import torch.distributed as dist

    from gaze_tpu_torch.core.distributed import global_mesh

    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", world_size=1, rank=0)
    mesh = global_mesh()
    emit("dist_init", backend=dist.get_backend(), world_size=dist.get_world_size(),
         rank=dist.get_rank(), device=str(mesh.device), mesh_size=mesh.size,
         mesh_rank=mesh.rank)
    if mesh.size != 1 or mesh.rank != 0 or mesh.device.type != "cuda":
        fail(f"dist_init: mesh {mesh}")
    return mesh


def dp_train_phase(torch, cuda, mesh, sp_state, at_state):
    """The data-parallel steps at world size 1 over NCCL against the same
    steps without a mesh: DP_STEPS SP steps from train_sp's initial state
    and batches (every K1/K2 call held to its plain version, exact
    launches per step), one TBPTT AT step from train_at's trained LSTM
    and one teacher-forced LF step from train_lf's initial state on its
    first batch; then the SP step's wall time in turns with the step
    without a mesh, its device busy time, and the gradient all-reduce by
    CUDA events. Returns the launch counts and the SP mesh run (the
    reference of dp_gloo2)."""
    from gaze_tpu_torch.core.distributed import all_reduce_flat_
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.train.at import build_tbptt_schedule, make_at_tbptt_step
    from gaze_tpu_torch.train.common import make_optimizer, make_state
    from gaze_tpu_torch.train.lf import create_lf_state, make_lf_train_step
    from gaze_tpu_torch.train.sp import create_sp_state, make_sp_train_step

    cfg = dp_config()
    per_step = flow_launches(cfg, 1)
    pipe = GazePipeline(cfg, seed=0)
    batches = sp_batches(cfg, TRAIN_B, DP_STEPS)      # train_sp's first batches
    total = {k: 0 for k in per_step}

    def run(make, create, batches, checked, extra=lambda b, m: b):
        """Fresh state, the steps over ``batches``: (snapshots after each
        step, losses, launches per step, the kernel check, the last
        state, the gradient each step applied, on the host)."""
        grads = []
        state = capture_grads(create(), grads)
        step = make()
        snaps, losses, launches, inside, metrics = [], [], [], None, None
        for b in batches:
            torch.cuda.synchronize()
            cuda.reset_launch_counts()
            with CheckedKernels(torch) if checked else contextlib.nullcontext() as chk:
                state, metrics = step(state, extra(b, metrics))
                torch.cuda.synchronize()
            if checked:
                inside = chk.check("dp_train", {"warp3": per_step["warp3"],
                                                "tvl1_pd": per_step["tvl1_pd"]})
            launches.append(launch_counts(cuda))
            losses.append(float(metrics["loss"]))
            snaps.append(state_snapshot(state))
            grads[-1] = [g.cpu() for g in grads[-1]]
        del state.apply_gradients                      # the timed steps record nothing
        return snaps, losses, launches, inside, state, grads

    def sp_create():
        return create_sp_state(pipe)                   # train_sp's initial state

    # SP: DP_STEPS steps without and with the mesh, from the same state
    ref = run(lambda: make_sp_train_step(pipe), sp_create, batches, False)
    dp = run(lambda: make_sp_train_step(pipe, mesh), sp_create, batches, True)
    for i, got in enumerate(dp[2]):
        if got != per_step:
            fail(f"dp_train sp: step {i} launched {got}, expected {per_step}")
        total = {k: total[k] + got[k] for k in total}
    names = dp[4].param_names
    sp_cmp = dp_compare(dp[0], ref[0], dp[1], ref[1], dp[5], ref[5], names)
    sp_inside = dp[3]
    sp_run = {"snapshots": dp[0], "losses": dp[1], "grads": dp[5], "names": names}

    # the SP step's wall in turns with the step without a mesh, from
    # their states; the device busy time of a mesh step; the all-reduce
    ref_state, dp_state = ref[4], dp[4]
    steps = {"plain": make_sp_train_step(pipe), "mesh": make_sp_train_step(pipe, mesh)}
    states = {"plain": ref_state, "mesh": dp_state}
    walls = {"plain": [], "mesh": []}   # from the states after DP_STEPS steps
    for turn in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[turn], _ = steps[turn](states[turn], batches[0])
        torch.cuda.synchronize()
        walls[turn].append((time.perf_counter() - t0) * 1e3)
    _, prof = device_profile(torch, lambda: steps["mesh"](states["mesh"], batches[1]))
    busy = busy_ms(prof)
    nccl_us, nccl_n = device_us(prof, "nccl")
    grads = [torch.zeros_like(p) for p in dp_state.params]
    loss = torch.zeros((), device=pipe.device)
    grad_bytes = 4 * (sum(g.numel() for g in grads) + 1)
    allreduce_ms = cuda_ms(torch, lambda: all_reduce_flat_(grads + [loss.reshape(1)], mesh), 10)
    del steps, states, ref_state, dp_state, grads, ref, dp
    torch.cuda.empty_cache()

    # AT: one TBPTT step from the trained LSTM on windows of numpy-seeded
    # fixation weights (two lanes of different lengths: unequal masks)
    at_cfg = cfg.at
    rng = np.random.default_rng(AT_SEED)
    videos = [rng.uniform(0, 1, (n, at_cfg.feature_dim)).astype(np.float32) for n in (9, 5)]
    sched = build_tbptt_schedule(videos, AT_SEQ_LEN, 2)[:1]
    shape = (2, at_cfg.num_layers, at_cfg.hidden_size)

    def at_create():
        pipe.lstm.load_state_dict(at_state)
        return make_state(pipe.lstm, make_optimizer(cfg.train))

    def with_carry(b, _):
        z = torch.zeros(shape, device=pipe.device)
        return dict(b, carry_c=z, carry_h=z)

    at_ref = run(lambda: make_at_tbptt_step(pipe), at_create, sched, False, with_carry)
    at_dp = run(lambda: make_at_tbptt_step(pipe, mesh), at_create, sched, False, with_carry)
    at_cmp = dp_compare(at_dp[0], at_ref[0], at_dp[1], at_ref[1], at_dp[5], at_ref[5],
                        at_dp[4].param_names)

    # LF: one teacher-forced step on the frozen trained SP and AT, from
    # train_lf's initial state and first batch
    frozen = {"sp": sp_state, "at": at_state}
    lf_batch = sp_batches(cfg, TRAIN_B, 1, seed=1)
    lf_ref = run(lambda: make_lf_train_step(pipe, frozen), lambda: create_lf_state(pipe),
                 lf_batch, False)
    lf_dp = run(lambda: make_lf_train_step(pipe, frozen, mesh), lambda: create_lf_state(pipe),
                lf_batch, True)
    if lf_dp[2][0] != per_step:
        fail(f"dp_train lf: launched {lf_dp[2][0]}, expected {per_step}")
    total = {k: total[k] + lf_dp[2][0][k] for k in total}
    lf_cmp = dp_compare(lf_dp[0], lf_ref[0], lf_dp[1], lf_ref[1], lf_dp[5], lf_ref[5],
                        lf_dp[4].param_names)

    wall_mesh, wall_plain = float(np.median(walls["mesh"])), float(np.median(walls["plain"]))
    emit("dp_train", world_size=mesh.size, backend="nccl", preset="parity", batch=TRAIN_B,
         size=SIZE, steps=DP_STEPS, launches_per_step=per_step, launches=total,
         kernels_inside_step=sp_inside, kernels_inside_lf_step=lf_dp[3],
         sp_vs_no_mesh=sp_cmp, at_vs_no_mesh=at_cmp, lf_vs_no_mesh=lf_cmp,
         step_wall_ms={"mesh": walls["mesh"], "no_mesh": walls["plain"]},
         step_wall_ms_median={"mesh": wall_mesh, "no_mesh": wall_plain},
         dp_overhead_ms=wall_mesh - wall_plain, step_device_busy_ms=busy,
         device_idle_share=1 - busy / wall_mesh,
         nccl_device_ms_in_step=nccl_us / 1e3, nccl_kernels_in_step=nccl_n,
         grad_allreduce_ms=allreduce_ms, grad_bytes_per_step=grad_bytes,
         sp_losses=sp_run["losses"], at_loss=at_dp[1][0], lf_loss=lf_dp[1][0])
    for name, c in (("sp", sp_cmp), ("at", at_cmp), ("lf", lf_cmp)):
        if not c["ok"]:
            fail(f"dp_train {name}: the mesh steps differ from the steps without a mesh: {c}")
    return total, sp_run


def gloo_serve(torch, cuda, mesh, shared):
    """The serve phase's script (submit() with the detach/attach drain)
    at world size ``mesh.size`` on three turbo servers: a
    DistributedStreamServer of this rank's SERVE_STREAMS / size slots
    (the attach and detach of its own slots only, so the ranks drain at
    different ticks), a StreamServer(mesh=) of the whole pool (every call
    on every rank), and a StreamServer without a mesh over this rank's
    slots, the reference of both. Returns each one's gaze per frame and
    launches."""
    from gaze_tpu_torch.serve import DistributedStreamServer, StreamServer

    cfg, dtype, qsp, weights = shared["cfg"], shared["dtype"], shared["qsp"], shared["weights"]
    batches, n = shared["batches"], SERVE_TICKS
    s_local = SERVE_STREAMS // mesh.size
    lo = mesh.rank * s_local

    def script(srv, local):
        def own(slots):
            return [s - lo for s in slots if lo <= s < lo + s_local] if local else list(slots)

        rows = slice(lo, lo + s_local) if local else slice(None)
        for i in own(range(S_ATTACHED)):
            srv.attach(i)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        gaze = []
        for t in range(n):
            if t == SERVE_SWAP_AT:
                for i in own(SERVE_DETACH):
                    srv.detach(i)
                for i in own(SERVE_ATTACH):
                    srv.attach(i)
            r = srv.submit(batches[t][rows])
            if t:
                gaze.append(r["gaze"])
        gaze.append(srv.flush()["gaze"])
        torch.cuda.synchronize()
        return {"gaze": np.stack(gaze), "launches": launch_counts(cuda)}

    def server(streams, **kw):
        return StreamServer(cfg, weights, streams, dtype=dtype, quant_sp=qsp, **kw)

    return {"distributed": script(DistributedStreamServer(cfg, weights, s_local, mesh=mesh,
                                                          dtype=dtype, quant_sp=qsp), True),
            "meshed": script(server(SERVE_STREAMS, mesh=mesh), False),
            "plain": script(server(s_local, device=mesh.device), True)}


def dp_gloo_worker(rank: int, world: int, init: str, out: str, shared: str) -> None:
    """One rank of dp_gloo2 (this script, started by dp_gloo2_phase): the
    SP steps of dp_train over a gloo group of ``world`` ranks on cuda:0,
    this rank feeding its rows of each global batch, then gloo_serve on
    the serve phase's weights and frames (``shared``). Saves its state,
    losses, applied gradients (rank 0), launches, step walls, the
    gradient all-reduce's time and the servers' results."""
    import torch
    import torch.distributed as dist

    from gaze_tpu_torch.core.distributed import all_reduce_flat_, global_mesh, initialize
    from gaze_tpu_torch.models.pipeline import GazePipeline
    from gaze_tpu_torch.ops import cuda
    from gaze_tpu_torch.parallel.mesh import shard_batch
    from gaze_tpu_torch.train.sp import create_sp_state, make_sp_train_step

    initialize(init, world, rank, backend="gloo")
    mesh = global_mesh(device="cuda:0")
    cfg = dp_config()
    pipe = GazePipeline(cfg, device=mesh.device, seed=0)
    applied = []
    state = capture_grads(create_sp_state(pipe), applied)
    step = make_sp_train_step(pipe, mesh)
    snaps, losses, walls, launches = [], [], [], []
    for b in sp_batches(cfg, TRAIN_B, DP_STEPS):
        local = shard_batch(mesh, b)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(launch_counts(cuda))
        losses.append(float(m["loss"]))
        snaps.append(state_snapshot(state))
    grads = [torch.zeros_like(p) for p in state.params] + [torch.zeros(1, device=mesh.device)]
    torch.cuda.synchronize()
    ar_host = []
    for _ in range(3):
        t0 = time.perf_counter()
        all_reduce_flat_(grads, mesh)
        torch.cuda.synchronize()
        ar_host.append((time.perf_counter() - t0) * 1e3)
    ar_events = cuda_ms(torch, lambda: all_reduce_flat_(grads, mesh), 3, 1)
    applied = [[g.cpu() for g in a] for a in applied] if rank == 0 else None
    del grads, state, step, pipe
    torch.cuda.empty_cache()
    serve = gloo_serve(torch, cuda, mesh, torch.load(shared, weights_only=False))
    torch.save({"snapshots": snaps, "losses": losses, "walls": walls, "grads": applied,
                "launches": launches, "allreduce_host_ms": ar_host,
                "allreduce_event_ms": ar_events, "local_batch": len(local["gaze"]),
                "serve": serve}, out)
    dist.destroy_process_group()


def dp_gloo2_phase(torch, sp_run, turbo, serve, tmp: str):
    """DP_GLOO_RANKS processes on the one card over gloo (NCCL refuses two
    ranks on one device), each this script as dp_gloo_worker: the ranks'
    states must be bit-equal, and within dp_train's bands of its world-1
    steps at the same global batch. Then the servers of gloo_serve: on
    each rank the DistributedStreamServer's gaze and the rank's rows of
    the StreamServer(mesh=)'s gaze bit-equal to the StreamServer without
    a mesh over the same slots, the meshed gaze equal on both ranks,
    exact launches per tick. Returns the training launches of both
    ranks and the servers' launches."""
    torch.cuda.empty_cache()
    init = f"file://{os.path.join(tmp, 'gloo_rendezvous')}"
    outs = [os.path.join(tmp, f"gloo_rank{r}.pt") for r in range(DP_GLOO_RANKS)]
    shared = os.path.join(tmp, "gloo_serve_inputs.pt")
    torch.save({k: turbo[k] for k in ("cfg", "dtype", "qsp", "weights")}
               | {"batches": serve["batches"]}, shared)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-gloo-worker",
                               str(r), str(DP_GLOO_RANKS), init, outs[r], shared],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_GLOO_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_GLOO_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        fail("dp_gloo2: a rank failed:\n" + "\n".join(log[-2000:] for log in logs))
    ranks = [torch.load(o, weights_only=False) for o in outs]   # written by this script's ranks
    bit_equal = ranks[0]["losses"] == ranks[1]["losses"]
    for (sd0, mom0), (sd1, mom1) in zip(ranks[0]["snapshots"], ranks[1]["snapshots"]):
        bit_equal &= (all(torch.equal(sd0[k], sd1[k]) for k in sd0)
                      and all(torch.equal(a, b) for a, b in zip(mom0, mom1)))
    vs_world1 = dp_compare(ranks[0]["snapshots"], sp_run["snapshots"], ranks[0]["losses"],
                           sp_run["losses"], ranks[0]["grads"], sp_run["grads"], sp_run["names"])
    per_step = flow_launches(dp_config(), 1)
    srv = [r["serve"] for r in ranks]
    s_local = SERVE_STREAMS // DP_GLOO_RANKS
    meshed = srv[0]["meshed"]["gaze"]
    serve_checks = {
        "distributed_equal_to_plain": [np.array_equal(s["distributed"]["gaze"],
                                                      s["plain"]["gaze"]) for s in srv],
        "meshed_rows_equal_to_plain": [
            np.array_equal(s["meshed"]["gaze"][:, r * s_local:(r + 1) * s_local],
                           s["plain"]["gaze"]) for r, s in enumerate(srv)],
        "meshed_equal_on_both_ranks": all(np.array_equal(s["meshed"]["gaze"], meshed)
                                          for s in srv),
        # not held: at world 1 the pool's 16 rows are one batch, here 8
        "meshed_slot_frames_equal_to_world1": int(sum(
            np.array_equal(meshed[f, i], serve["results"][f][i])
            for f in range(SERVE_TICKS) for i in range(SERVE_STREAMS))),
        "slot_frames": SERVE_TICKS * SERVE_STREAMS}
    serve_want = {k: v * SERVE_TICKS for k, v in turbo["per_step"].items()}
    emit("dp_gloo2", world_size=DP_GLOO_RANKS, backend="gloo", device="cuda:0 (shared)",
         global_batch=TRAIN_B, local_batch=ranks[0]["local_batch"], steps=DP_STEPS,
         ranks_bit_equal=bit_equal, vs_world1_nccl=vs_world1,
         step_wall_ms=[r["walls"] for r in ranks],
         grad_allreduce_ms_gloo_host_memory={"host_clock": [r["allreduce_host_ms"] for r in ranks],
                                             "cuda_events": [r["allreduce_event_ms"]
                                                             for r in ranks]},
         launches=[r["launches"] for r in ranks], phase_wall_s=wall,
         servers=serve_checks, servers_streams_per_rank=s_local,
         servers_launches=[{k: v["launches"] for k, v in s.items()} for s in srv],
         servers_launches_expected=serve_want)
    for r in ranks:
        for i, got in enumerate(r["launches"]):
            if got != per_step:
                fail(f"dp_gloo2: a rank's step {i} launched {got}, expected {per_step}")
    if not bit_equal:
        fail("dp_gloo2: the two ranks' states or losses differ")
    if not vs_world1["ok"]:
        fail(f"dp_gloo2: world 2 differs from world 1 beyond the bands: {vs_world1}")
    for s in srv:
        for name, run in s.items():
            if run["launches"] != serve_want:
                fail(f"dp_gloo2: the {name} server launched {run['launches']}, "
                     f"expected {serve_want}")
    if not (all(serve_checks["distributed_equal_to_plain"])
            and all(serve_checks["meshed_rows_equal_to_plain"])
            and serve_checks["meshed_equal_on_both_ranks"]):
        fail(f"dp_gloo2: the world-2 servers differ from the servers without a mesh: "
             f"{serve_checks}")
    train = {k: sum(sum(c[k] for c in r["launches"]) for r in ranks) for k in per_step}
    servers = {k: sum(s[name]["launches"][k] for s in srv for name in ("distributed", "meshed"))
               for k in serve_want}
    return train, servers


def dist_serve_phase(torch, cuda, turbo, serve, mesh):
    """The serve phase's script (submit() with the detach/attach drain,
    then direct ticks) on a turbo DistributedStreamServer of 16 slots at
    world size 1 and on a StreamServer(mesh=global mesh): gaze bit-equal
    to serve's StreamServer, exact launches per tick. Returns the
    distributed server's launches."""
    from gaze_tpu_torch.serve import DistributedStreamServer, StreamServer

    cfg, dtype, qsp, weights = turbo["cfg"], turbo["dtype"], turbo["qsp"], turbo["weights"]
    per_tick = turbo["per_step"]
    batches, n = serve["batches"], SERVE_TICKS

    def script(srv, name):
        for i in range(S_ATTACHED):
            srv.attach(i)
        results = {}
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(n):
            if t == SERVE_SWAP_AT:
                for i in SERVE_DETACH:
                    srv.detach(i)
                for i in SERVE_ATTACH:
                    srv.attach(i)
            r = srv.submit(batches[t])
            want = {k: v * t for k, v in per_tick.items()}
            if launch_counts(cuda) != want:
                fail(f"dist_serve {name}: submit {t} launched {launch_counts(cuda)}, "
                     f"expected {want}")
            if t:
                results[t - 1] = r["gaze"]
        results[n - 1] = srv.flush()["gaze"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(cuda)
        ticks = [srv.tick(batches[t])["gaze"] for t in range(SERVE_DIRECT_TICKS)]
        equal = (all(np.array_equal(results[f], serve["results"][f]) for f in range(n))
                 and all(np.array_equal(a, b) for a, b in zip(ticks, serve["tick_gaze"])))
        return {"equal": equal, "launches": launches, "wall_s": wall}

    dist = script(DistributedStreamServer(cfg, weights, SERVE_STREAMS, mesh=mesh, dtype=dtype,
                                          quant_sp=qsp), "DistributedStreamServer")
    meshed = script(StreamServer(cfg, weights, SERVE_STREAMS, dtype=dtype, quant_sp=qsp,
                                 mesh=mesh), "StreamServer(mesh=)")
    emit("dist_serve", world_size=mesh.size, streams=SERVE_STREAMS, attached_at_start=S_ATTACHED,
         ticks=n, direct_ticks=SERVE_DIRECT_TICKS, launches_per_tick=per_tick,
         distributed={"gaze_bit_equal_to_serve": dist["equal"], "launches": dist["launches"],
                      "submit_run_wall_s": dist["wall_s"]},
         meshed={"gaze_bit_equal_to_serve": meshed["equal"], "launches": meshed["launches"],
                 "submit_run_wall_s": meshed["wall_s"]})
    if not dist["equal"] or not meshed["equal"]:
        fail(f"dist_serve: gaze differs from serve's StreamServer (distributed "
             f"{dist['equal']}, meshed {meshed['equal']})")
    want = {k: v * n for k, v in per_tick.items()}
    if dist["launches"] != want or meshed["launches"] != want:
        fail(f"dist_serve: launches {dist['launches']}, {meshed['launches']}, expected {want}")
    return dist["launches"]


def dist_rollout_phase(torch, cuda, turbo, rollout, mesh):
    """``rollout_eval_arrays(mesh=global mesh)`` at world size 1 over the
    rollout phase's videos at chunks of 8: sums equal to that phase's,
    exact launches. Returns the launches."""
    from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    sums = rollout_eval_arrays(turbo["pipe"], *rollout["inputs"], chunk_len=ROLL_CHUNKS[0],
                               mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts(cuda)
    expect = {k: c * (ROLL_T - 1) for k, c in turbo["per_step"].items()}
    equal = all(np.array_equal(a, b) for a, b in zip(sums, rollout["sums"]))
    emit("dist_rollout", world_size=mesh.size, videos=ROLL_V, frames=ROLL_T,
         chunk_len=ROLL_CHUNKS[0], seconds=secs, sums_equal_to_rollout=equal,
         counts=sums[2].tolist(), launches=launches)
    if launches != expect:
        fail(f"dist_rollout: launches {launches}, expected {expect}")
    if not equal:
        fail("dist_rollout: the sums differ from the rollout phase's")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA card")
    try:
        from gaze_tpu_torch.core.config import parity_config
        from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
        from gaze_tpu_torch.ops import cuda
        from gaze_tpu_torch.ops.cuda.tvl1_pd import pd_iterations
        from gaze_tpu_torch.ops.cuda.warp import warp3
        from gaze_tpu_torch.ops.image import central_gradient
        from gaze_tpu_torch.ops.tvl1 import _pyramid_shapes, tvl1_flow
        from gaze_tpu_torch.ops.warp import warp3_plain
    except ImportError as e:
        fail(f"cannot import gaze_tpu_torch ({e}); run from the repository root")
    import torch.nn.functional as F

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    build_s = cuda.build_all()
    for k in cuda.kernels().values():
        k.load()
    emit("gpu", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s)

    rng = np.random.default_rng(0)
    summary = {}

    # ------------------------------------------------------------- K1
    k1_err = 0.0
    main_shape = (B, SIZE, SIZE)
    for shape in [(B, 224, 224), (B, 112, 112), (B, 56, 56), (B, 28, 28), (2, 48, 200)]:
        n, H, W = shape
        tex = textures(rng, n, H, W)
        i1 = torch.from_numpy(tex() * 255.0).to(dev)
        i0 = torch.from_numpy(tex(0.7, -0.4) * 255.0).to(dev)
        i1x, i1y = (g.contiguous() for g in central_gradient(i1))
        yy, xx = np.mgrid[0:H, 0:W]
        # displacements to +-40 px, past the TPU kernel's +-16 clamp
        u1 = 39.0 * np.sin(xx / 23.0 + rng.uniform(0, 3)) + rng.uniform(-1, 1, shape)
        u2 = 39.0 * np.cos(yy / 19.0 + rng.uniform(0, 3)) + rng.uniform(-1, 1, shape)
        u1 = torch.from_numpy(u1.astype(np.float32)).to(dev)
        u2 = torch.from_numpy(u2.astype(np.float32)).to(dev)
        args = (i1, i1x, i1y, u1, u2, i0)
        got = warp3(*args)
        ref = warp3_plain(*args)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        rel = max(float(((g - r).abs() / r.abs().clamp(min=1.0)).max()) for g, r in zip(got, ref))
        if not rel <= K1_TOL:
            fail(f"K1 warp3 {shape}: relative error {rel} > {K1_TOL}")
        k1_err = max(k1_err, err)
        # library yardstick: grid_sample of the 3 fields (no epilogue)
        stack = torch.stack([i1, i1x, i1y], dim=1)
        gx = torch.arange(W, device=dev).view(1, 1, W) + u1
        gy = torch.arange(H, device=dev).view(1, H, 1) + u2
        grid = torch.stack([2 * gx / (W - 1) - 1, 2 * gy / (H - 1) - 1], dim=-1)
        reps = 200 if H >= 112 else 500
        ms = cuda_ms(torch, lambda: warp3(*args), reps)
        plain = cuda_ms(torch, lambda: warp3_plain(*args), 50)
        def sample():
            return F.grid_sample(stack, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)

        lib = cuda_ms(torch, sample, reps)
        _, prof = device_profile(torch, lambda: [warp3(*args) for _ in range(20)])
        dev_us, dev_n = device_us(prof, "warp3_kernel")
        # grid_sample's device time, to hold against K1's device time: its
        # event time, like K1's, includes the host's launch cost
        _, prof = device_profile(torch, lambda: [sample() for _ in range(20)])
        lib_us, lib_n = device_us(prof, "grid_sampler")
        nbytes = 10 * 4 * n * H * W
        bound = max(nbytes / HBM_BYTES_PER_S, K1_FLOPS_PER_PIXEL * n * H * W / F32_FLOPS) * 1e3
        emit("K1", shape=list(shape), max_abs_err=err, max_rel_err=rel, tol=K1_TOL,
             kernel_ms=ms, kernel_device_us=dev_us / dev_n if dev_n else None,
             plain_ms=plain, library_ms=lib,
             library_device_us=lib_us / lib_n if lib_n else None, bound_us=bound * 1e3)
        if shape == main_shape:
            summary["warp3"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                    bound_by="bytes",
                                    device_ms=dev_us / dev_n / 1e3 if dev_n else None,
                                    library_device_ms=lib_us / lib_n / 1e3 if lib_n else None)
    summary["warp3"]["max_abs_err"] = k1_err

    # ------------------------------------------------------------- K2
    cfg = parity_config()
    t1 = cfg.tvl1
    k2_err = 0.0
    k2_counter = cuda.kernels()["tvl1_pd"]

    for shape in [(B, 224, 224), (B, 112, 112), (B, 56, 56), (B, 28, 28), (2, 24, 40)]:
        n, H, W = shape
        tex = textures(rng, n, H, W)
        i1 = torch.from_numpy(tex() * 255.0).to(dev)
        i1wx, i1wy = (g.contiguous() for g in central_gradient(i1))
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = torch.from_numpy(rng.uniform(-40, 40, shape).astype(np.float32)).to(dev)
        u = [torch.from_numpy(rng.uniform(-2, 2, shape).astype(np.float32)).to(dev)
             for _ in range(2)]
        p = []
        for j in range(4):
            q = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
            if j % 2 == 0:
                q[:, :, -1] = 0   # x-duals zero in the last column
            else:
                q[:, -1, :] = 0   # y-duals zero in the last row
            p.append(torch.from_numpy(q).to(dev))
        args = (*u, *p, i1wx, i1wy, grad, rho_c)
        # parity's 10 iterations and turbo's 5; both paths take one median
        # pass between warps (median_kernel 3), median_kernel 5 takes two
        for iters in (t1.iters, 5):
            kw = dict(iters=iters, tau=t1.tau, lambda_=t1.lambda_, theta=t1.theta)
            for passes in (0, 1, 2):
                got = pd_iterations(*args, median_passes=passes, **kw)
                ref = k2_plain(args, kw, passes)
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                if not err <= K2_TOL:
                    fail(f"K2 pd_iterations {shape} iters={iters} median_passes={passes}: "
                         f"max abs error {err} > {K2_TOL}")
                k2_err = max(k2_err, err)
                equal = all(torch.equal(g, r) for g, r in zip(got, ref))
                ms = cuda_ms(torch, lambda: pd_iterations(*args, median_passes=passes, **kw),
                             50 if H >= 112 else 200)
                plain = (cuda_ms(torch, lambda: k2_plain(args, kw, passes), 10)
                         if passes == 1 else None)
                _, prof = device_profile(
                    torch, lambda: [pd_iterations(*args, median_passes=passes, **kw)
                                    for _ in range(10)])
                dev_us, dev_n = device_us(prof, "pd_iterations_kernel")
                nbytes = 16 * 4 * n * H * W
                flops = (K2_FLOPS_PER_PIXEL_ITER * iters
                         + K2_OPS_PER_PIXEL_MEDIAN * passes) * n * H * W
                bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
                before = k2_counter.launches
                pd_iterations(*args, median_passes=passes, **kw)
                per_call = k2_counter.launches - before
                emit("K2", shape=list(shape), iters=iters, median_passes=passes, design=K2_DESIGN,
                     max_abs_err=err, bitwise_equal=equal, tol=K2_TOL, kernel_ms=ms,
                     kernel_device_us=dev_us / dev_n if dev_n else None,
                     launches_per_call=per_call, plain_ms=plain, library_ms=None,
                     bound_us=bound * 1e3)
                if per_call != 1:
                    fail(f"K2 {shape}: {per_call} kernel launches for one call, expected 1")
                if shape == main_shape and iters == t1.iters and passes == 1:
                    summary["tvl1_pd"] = dict(
                        ms=ms, device_ms=dev_us / dev_n / 1e3 if dev_n else None,
                        plain_ms=plain, library_ms=None,
                        bound_ms=bound, bitwise_equal=equal,
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
                        else "operations")
    summary["tvl1_pd"]["max_abs_err"] = k2_err

    # ----------------------------------------------------------- tvl1
    tex = textures(rng, 2, SIZE, SIZE)
    i0 = torch.from_numpy(tex()).to(dev)
    i1 = torch.from_numpy(tex(*TVL1_SHIFT)).to(dev)
    plain_cfg = dataclasses.replace(t1, use_pallas_warp=False, use_pallas_pd=False)
    tvl1_flow(i0, i1, t1)          # warm-up: cuDNN plans of the pyramid blur
    tvl1_flow(i0, i1, plain_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow_k = tvl1_flow(i0, i1, t1)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    flow_p = tvl1_flow(i0, i1, plain_cfg)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    inner = flow_k[:, 16:-16, 16:-16].reshape(-1, 2)
    med = inner.median(dim=0).values.tolist()
    d = (flow_k - flow_p).abs().flatten()
    d_max, d_p999 = float(d.max()), float(torch.quantile(d[:2 ** 24].float(), 0.999))
    emit("tvl1", shift=list(TVL1_SHIFT), median_flow=med, shift_tol=TVL1_SHIFT_TOL,
         kernel_vs_plain_max=d_max, kernel_vs_plain_p999=d_p999, band=TVL1_BAND,
         kernel_path_s=t_kernel, plain_path_s=t_plain,
         levels=len(_pyramid_shapes(SIZE, SIZE, t1.pyramid_levels, t1.pyramid_factor)))
    if not all(abs(m - s) <= TVL1_SHIFT_TOL for m, s in zip(med, TVL1_SHIFT)):
        fail(f"tvl1: median flow {med} is not within {TVL1_SHIFT_TOL} px of {TVL1_SHIFT}")
    if not d_max <= TVL1_BAND:
        fail(f"tvl1: kernel path differs from the plain path by {d_max} px > {TVL1_BAND}")

    # ---------------------------------------------------------- slice
    pipe = GazePipeline(cfg, seed=0)          # device=None: the card
    tex = textures(rng, 3 * B, SIZE, SIZE)
    drift = np.cumsum(rng.uniform(-2, 2, (T + 1, 2)), axis=0)
    frames = np.stack([tex(*drift[t]).reshape(B, 3, SIZE, SIZE) for t in range(T + 1)], 1)
    frames = np.round(frames.transpose(0, 1, 3, 4, 2) * 255).astype(np.uint8)  # (B,T+1,H,W,3)
    pattern = np.array([0, 1, 1, 1, 0, 0, 1, 1, 1], np.float32)
    fixsac = np.stack([np.roll(pattern, b)[: T + 1] for b in range(B)])
    run_clip(pipe, frames[:, :2], fixsac[:, :2])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    heatmaps, gaze = run_clip(pipe, frames, fixsac)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in cuda.kernels().items()}
    peak = torch.cuda.max_memory_allocated()
    levels = len(_pyramid_shapes(SIZE, SIZE, t1.pyramid_levels, t1.pyramid_factor))
    expect = {"warp3": levels * t1.warps * T, "tvl1_pd": levels * t1.warps * T,
              "conv3x3_int8": 0}
    if launches != expect:
        fail(f"slice: kernel launches {launches}, expected {expect}")
    if tuple(heatmaps.shape) != (B, T, SIZE, SIZE) or tuple(gaze.shape) != (B, T, 2):
        fail(f"slice: shapes {tuple(heatmaps.shape)}, {tuple(gaze.shape)}")
    if not bool(torch.isfinite(heatmaps).all()) or not bool(torch.isfinite(gaze).all()):
        fail("slice: non-finite outputs")
    if float(heatmaps.min()) < 0 or float(heatmaps.max()) > 1:
        fail("slice: heatmap outside [0, 1]")
    if float(gaze.min()) < 0 or float(gaze.max()) > SIZE - 1:
        fail("slice: gaze outside the image")

    # per-stage times of one step on the same frames (CUDA events)
    state = pipe.init_state(B)
    prev = torch.from_numpy(frames[:, 0]).to(dev)
    cur = torch.from_numpy(frames[:, 1]).to(dev)
    fix = torch.from_numpy(fixsac[:, 1]).to(dev)
    with torch.inference_mode():
        rgb_in, flow_in = pipe.preprocess_pair(prev, cur)
        sal, feat = pipe.sp_forward(rgb_in, flow_in)
        stage_ms = {
            "tvl1_preprocess": cuda_ms(torch, lambda: pipe.preprocess_pair(prev, cur), 3, 1),
            "sp": cuda_ms(torch, lambda: pipe.sp_forward(rgb_in, flow_in), 3, 1),
            "at_lf": cuda_ms(torch, lambda: pipe.attend(state, sal, feat, fix), 10, 2),
        }
        # the same stages' device busy time (profiler): the rest is idle
        stage_device_ms = {
            name: busy_ms(device_profile(torch, fn)[1]) for name, fn in (
                ("tvl1_preprocess", lambda: pipe.preprocess_pair(prev, cur)),
                ("sp", lambda: pipe.sp_forward(rgb_in, flow_in)),
                ("at_lf", lambda: pipe.attend(state, sal, feat, fix)))
        }
    # device busy share of a clip step: a profiled 2-step clip's device
    # time against the unprofiled clip's wall time per step
    _, prof = device_profile(torch, lambda: run_clip(pipe, frames[:, :3], fixsac[:, :3]))
    step_busy_ms = busy_ms(prof) / 2
    step_wall_ms = wall * 1e3 / T
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:8]
    top_kernels = [{"name": k[:90], "ms_per_step": v[0] / 2e3, "launches_per_step": v[1] / 2}
                   for k, v in top]
    k2_dev_us, k2_n = device_us(prof, "pd_iterations_kernel")

    # the same clip, B=1 x T=2, on the CPU through the plain path
    cpu = GazePipeline(cfg, device="cpu")
    cpu.load_state_dicts(pipe.state_dicts())
    t0 = time.perf_counter()
    hm_c, gaze_c = run_clip(cpu, frames[:1, :3], fixsac[:1, :3])
    t_cpu = time.perf_counter() - t0
    hm_g, gaze_g = heatmaps[:1, :2].cpu(), gaze[:1, :2].cpu()
    hm_diff = float((hm_g - hm_c).abs().max())
    near_ties, mismatched, tie = gaze_vs_cpu(hm_g, gaze_g, hm_c, gaze_c)
    emit("slice", batch=B, frames=T, size=SIZE, frames_per_s=B * T / wall, wall_s=wall,
         stage_ms=stage_ms, stage_device_ms=stage_device_ms, step_wall_ms=step_wall_ms,
         step_device_busy_ms=step_busy_ms, device_idle_share=1 - step_busy_ms / step_wall_ms,
         k2_device_ms_per_step=k2_dev_us / 2e3, k2_launches_per_step=k2_n / 2,
         launches_per_step=sum(v[1] for v in prof.values()) / 2,
         top_kernels=top_kernels, peak_mem_bytes=peak, launches=launches,
         cpu_frames=2, cpu_s=t_cpu, cpu_heatmap_max_diff=hm_diff,
         cpu_heatmap_tol=CPU_HEATMAP_TOL, cpu_gaze_max_diff=float((gaze_g - gaze_c).abs().max()),
         cpu_near_tie_frames=near_ties, cpu_near_tie_threshold=tie,
         gaze_first_stream=gaze[0].tolist())
    if mismatched:
        fail(f"slice: gaze differs from the CPU run at frames {mismatched}")
    if not hm_diff <= CPU_HEATMAP_TOL:
        fail(f"slice: heatmaps differ from the CPU run by {hm_diff} > {CPU_HEATMAP_TOL}")

    del pipe, cpu, heatmaps, gaze
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- K3
    summary["conv3x3_int8"] = k3_phase(torch, dev, rng)

    # ---------------------------------------------------------- turbo
    turbo = turbo_phase(torch, dev, cuda, frames, fixsac)
    turbo_launches = turbo["launches"]

    # ---------------------------------------------------------- serve
    serve = serve_phase(torch, cuda, turbo, frames, fixsac, rng)
    serve_launches = serve["launches"]

    # -------------------------------------------------------- rollout
    rollout = rollout_phase(torch, cuda, turbo)
    rollout_launches = rollout["launches"]

    # ----------------------------------------------------------- tail
    tail_launches = tail_phase(torch, dev, cuda, turbo, frames, fixsac)
    torch.cuda.empty_cache()

    # ------------------------------------------------------- training
    sp_state, train_launches = train_sp_phase(torch, cuda)
    qat_launches = qat_phase(torch, cuda, sp_state)
    torch.cuda.empty_cache()
    at_state, at_launches = train_at_phase(torch, cuda, sp_state)
    training = {"train_sp": train_launches, "qat": qat_launches, "train_at": at_launches,
                "train_lf": train_lf_phase(torch, cuda, sp_state, at_state),
                "stages": stages_phase(torch, cuda)}

    # --------------------------------------------------- distributed
    dist_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        mesh = dist_init_phase(torch, os.path.join(dist_dir, "nccl_rendezvous"))
        training["dp_train"], sp_run = dp_train_phase(torch, cuda, mesh, sp_state, at_state)
        training["dp_gloo2"], gloo2_servers = dp_gloo2_phase(torch, sp_run, turbo, serve,
                                                             dist_dir)
        dist_launches = {"dist_serve": dist_serve_phase(torch, cuda, turbo, serve, mesh),
                         "dist_serve_gloo2": gloo2_servers,
                         "dist_rollout": dist_rollout_phase(torch, cuda, turbo, rollout, mesh)}
    finally:
        # also on a failed check: a live NCCL group holds the exit for
        # its watchdog's timeout
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(dist_dir, ignore_errors=True)
    del sp_state, at_state, sp_run
    torch.cuda.empty_cache()

    # ----------------------------------------------------- data layer
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_gtea_")
    try:
        names = dataset_phase(torch, cuda, data_dir, rng)
        data_launches = {"dataset": launch_counts(cuda)}
        data_launches["extract"], k2_levels = extract_phase(torch, dev, cuda, data_dir, names)
        data_launches["videos_tvl1"], data_launches["videos_flow_images"] = videos_phase(
            torch, cuda, turbo, data_dir, names)
        training["data_stages_off"], training["data_stages_auto"] = data_stages_phase(
            torch, cuda, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    if os.path.exists(data_dir):
        fail(f"data: {data_dir} was not removed")

    # ------------------------------------------------------- kernels
    sources = {"warp3": ("gaze_tpu_torch/csrc/warp.cu", "gaze_tpu/ops/pallas/warp.py:194"),
               "tvl1_pd": ("gaze_tpu_torch/csrc/tvl1_pd.cu",
                           "gaze_tpu/ops/pallas/tvl1_pd.py:121"),
               "conv3x3_int8": ("gaze_tpu_torch/csrc/conv_int8.cu",
                                "gaze_tpu/ops/pallas/conv_int8.py:171")}
    units = {"warp3": "one call at B=8x224^2",
             "tvl1_pd": "one call at B=8x224^2: 10 iterations and one median pass",
             "conv3x3_int8": "one turbo step: its 24 layer launches at B=8, 224^2"}
    rows = []
    for name in cuda.kernels():
        src, replaces = sources[name]
        s = summary[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": turbo_launches[name],
                     "launches_by_path": {"parity": launches[name], "turbo": turbo_launches[name],
                                          "serve": serve_launches[name],
                                          "rollout": rollout_launches[name],
                                          "tail": tail_launches[name],
                                          **{k: c[name] for k, c in dist_launches.items()},
                                          **{k: c[name] for k, c in data_launches.items()}},
                     "training_launches": {path: c[name] for path, c in training.items()},
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                     "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                     "library_ms": s["library_ms"], "per": units[name],
                     "device_ms": s["device_ms"]})
        if name in ("warp3", "conv3x3_int8"):
            rows[-1]["library_device_ms"] = s["library_device_ms"]
        if name == "tvl1_pd":
            rows[-1]["bitwise_equal"] = s["bitwise_equal"]
            rows[-1]["dense_flow_by_level"] = [
                {k: r[k] for k in ("shape", "iters", "median_passes", "ms", "device_ms",
                                   "bound_ms", "bitwise_equal")} for r in k2_levels]
        if name == "conv3x3_int8":
            rows[-1]["device_ms_in_turbo_clip"] = turbo["k3_device_ms_per_step"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-gloo-worker"]:
        dp_gloo_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                       sys.argv[6])
    else:
        main()
