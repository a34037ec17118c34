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

Each path runs with the launch counters set to 0 just before it and read
just after, and must have launched each of its kernels as often as its
configuration says. A short CPU run of each clip with the same weights is
compared with the card's. Every phase prints one JSON line; any failed
check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``. All inputs come from numpy seeds and
all weights from a ``torch.Generator`` seed.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
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


def device_profile(torch, fn):
    """Run ``fn`` once under ``torch.profiler``. Returns the host wall
    seconds and, per device kernel name, (device µs summed, launches) from
    the CUPTI trace. The CUDA-event times above include the wrapper's host
    cost when the host enqueues slower than the card runs; these do not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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


def gaze_vs_cpu(hm_g, gaze_g, hm_c, gaze_c):
    """(near-tie frames, mismatched frames, tie threshold) of stream 0:
    the card's gaze may differ from the CPU run's only where its pick is
    within max(NEAR_TIE, 2 x the heatmap difference) of the CPU maximum."""
    tie = max(NEAR_TIE, 2 * float((hm_g - hm_c).abs().max()))
    near_ties, mismatched = [], []
    for tt in range(gaze_g.shape[1]):
        if not gaze_g[0, tt].equal(gaze_c[0, tt]):
            gx, gy = (int(v) for v in gaze_g[0, tt])
            gap = float(hm_c[0, tt].max() - hm_c[0, tt, gy, gx])
            (near_ties if gap < tie else mismatched).append(tt)
    return near_ties, mismatched, tie


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
    step = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                ops_ms=0.0, bytes_ms=0.0)
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
        ops = 2 * n * H * W * 9 * ci * co
        nbytes = n * H * W * ci + co * 9 * ci + ref.numel() * (4 if dequant else 1) \
            + 4 * co * (3 if dequant else 2)
        ops_ms, bytes_ms = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        emit("K3", layer=name, shape=[n, H, W, ci, co],
             epilogue="dequant" if dequant else "requant, 2x2 max-pool" if pool else "requant",
             max_abs_err=err, bitwise_equal=True, kernel_ms=ms,
             kernel_device_us=dev_us / dev_n if dev_n else None, plain_ms=plain,
             library_ms=lib, bound_us=bound * 1e3,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             tops=ops / ms / 1e9)
        if name in step_layers:   # each runs once per stream: twice per step
            step["ms"] += 2 * ms
            step["device_ms"] += 2 * (dev_us / dev_n / 1e3 if dev_n else float("nan"))
            step["plain_ms"] += 2 * plain
            step["library_ms"] += 2 * lib
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
    Returns its launch counts."""
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
    return launches, k3_dev_us / 2e3


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA card")
    try:
        from gaze_tpu_torch.core.config import parity_config
        from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
        from gaze_tpu_torch.ops import cuda
        from gaze_tpu_torch.ops.cuda.tvl1_pd import pd_iterations, pd_iterations_plain
        from gaze_tpu_torch.ops.cuda.warp import warp3
        from gaze_tpu_torch.ops.image import central_gradient, median3x3
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

    def k2_plain(args, kw, passes):
        out = pd_iterations_plain(*args, **kw)
        f1, f2 = out[:2]
        for _ in range(passes):
            f1, f2 = median3x3(f1), median3x3(f2)
        return (f1, f2, *out[2:])

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
    turbo_launches, k3_step_device_ms = turbo_phase(torch, dev, cuda, frames, fixsac)

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
                     "launches_by_path": {"parity": launches[name], "turbo": turbo_launches[name]},
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                     "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                     "library_ms": s["library_ms"], "per": units[name],
                     "device_ms": s["device_ms"]})
        if name == "warp3":
            rows[-1]["library_device_ms"] = s["library_device_ms"]
        if name == "tvl1_pd":
            rows[-1]["bitwise_equal"] = s["bitwise_equal"]
        if name == "conv3x3_int8":
            rows[-1]["device_ms_in_turbo_clip"] = k3_step_device_ms
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
