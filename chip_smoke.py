#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaze_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from gaze_tpu_torch/csrc with nvcc,
holds each kernel against its plain PyTorch version on the card, checks
that TV-L1 recovers a known translation, drives the parity-preset gaze
path at full width (224², two VGG16 streams, 512-wide LSTM, LF head,
TV-L1 4 levels x 5 warps x 10 iterations) through ``run_clip`` for B=8
streams x T=8 frames, checks that the path went through the kernels, and
compares a short CPU run of the same clip and weights. Every phase prints
one JSON line; any failed check exits non-zero before the last line,
which is ``{"ok": true, "device": {...}}``. All inputs come from numpy
seeds and all weights from a ``torch.Generator`` seed.
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
K1_FLOPS_PER_PIXEL = 43     # coordinates, weights, 3 x 4 taps, epilogue
K2_FLOPS_PER_PIXEL_ITER = 54
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
B, T, SIZE = 8, 8, 224


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
        lib = cuda_ms(torch, lambda: F.grid_sample(
            stack, grid, mode="bilinear", padding_mode="border", align_corners=True), reps)
        _, prof = device_profile(torch, lambda: [warp3(*args) for _ in range(20)])
        dev_us, dev_n = device_us(prof, "warp3_kernel")
        nbytes = 10 * 4 * n * H * W
        bound = max(nbytes / HBM_BYTES_PER_S, K1_FLOPS_PER_PIXEL * n * H * W / F32_FLOPS) * 1e3
        emit("K1", shape=list(shape), max_abs_err=err, max_rel_err=rel, tol=K1_TOL,
             kernel_ms=ms, kernel_device_us=dev_us / dev_n if dev_n else None,
             plain_ms=plain, library_ms=lib, bound_us=bound * 1e3)
        if shape == main_shape:
            summary["warp3"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                    bound_by="bytes")
    summary["warp3"]["max_abs_err"] = k1_err

    # ------------------------------------------------------------- K2
    cfg = parity_config()
    t1 = cfg.tvl1
    kw = dict(iters=t1.iters, tau=t1.tau, lambda_=t1.lambda_, theta=t1.theta)
    k2_err = 0.0
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
        got = pd_iterations(*args, **kw)
        ref = pd_iterations_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        if not err <= K2_TOL:
            fail(f"K2 pd_iterations {shape}: max abs error {err} > {K2_TOL}")
        k2_err = max(k2_err, err)
        ms = cuda_ms(torch, lambda: pd_iterations(*args, **kw), 100 if H >= 112 else 300)
        plain = cuda_ms(torch, lambda: pd_iterations_plain(*args, **kw), 20)
        _, prof = device_profile(torch, lambda: [pd_iterations(*args, **kw) for _ in range(5)])
        dev_us, dev_n = device_us(prof, "pd_iteration_kernel")
        nbytes = 16 * 4 * n * H * W
        flops = K2_FLOPS_PER_PIXEL_ITER * t1.iters * n * H * W
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        emit("K2", shape=list(shape), iters=t1.iters, max_abs_err=err, tol=K2_TOL,
             kernel_ms=ms, kernel_device_us=dev_us * t1.iters / dev_n if dev_n else None,
             plain_ms=plain, library_ms=None, bound_us=bound * 1e3)
        if shape == main_shape:
            summary["tvl1_pd"] = dict(
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
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
    expect = {"warp3": levels * t1.warps * T, "tvl1_pd": levels * t1.warps * t1.iters * T}
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

    # the same clip, B=1 x T=2, on the CPU through the plain path
    cpu = GazePipeline(cfg, device="cpu")
    cpu.load_state_dicts(pipe.state_dicts())
    t0 = time.perf_counter()
    hm_c, gaze_c = run_clip(cpu, frames[:1, :3], fixsac[:1, :3])
    t_cpu = time.perf_counter() - t0
    hm_g, gaze_g = heatmaps[:1, :2].cpu(), gaze[:1, :2].cpu()
    hm_diff = float((hm_g - hm_c).abs().max())
    tie = max(NEAR_TIE, 2 * hm_diff)
    near_ties, mismatched = [], []
    for tt in range(2):
        if not torch.equal(gaze_g[0, tt], gaze_c[0, tt]):
            gx, gy = (int(v) for v in gaze_g[0, tt])
            gap = float(hm_c[0, tt].max() - hm_c[0, tt, gy, gx])
            (near_ties if gap < tie else mismatched).append(tt)
    emit("slice", batch=B, frames=T, size=SIZE, frames_per_s=B * T / wall, wall_s=wall,
         stage_ms=stage_ms, stage_device_ms=stage_device_ms, step_wall_ms=step_wall_ms,
         step_device_busy_ms=step_busy_ms, device_idle_share=1 - step_busy_ms / step_wall_ms,
         top_kernels=top_kernels, peak_mem_bytes=peak, launches=launches,
         cpu_frames=2, cpu_s=t_cpu, cpu_heatmap_max_diff=hm_diff,
         cpu_heatmap_tol=CPU_HEATMAP_TOL, cpu_gaze_max_diff=float((gaze_g - gaze_c).abs().max()),
         cpu_near_tie_frames=near_ties, cpu_near_tie_threshold=tie,
         gaze_first_stream=gaze[0].tolist())
    if mismatched:
        fail(f"slice: gaze differs from the CPU run at frames {mismatched}")
    if not hm_diff <= CPU_HEATMAP_TOL:
        fail(f"slice: heatmaps differ from the CPU run by {hm_diff} > {CPU_HEATMAP_TOL}")

    # ------------------------------------------------------- kernels
    sources = {"warp3": ("gaze_tpu_torch/csrc/warp.cu", "gaze_tpu/ops/pallas/warp.py:194"),
               "tvl1_pd": ("gaze_tpu_torch/csrc/tvl1_pd.cu",
                           "gaze_tpu/ops/pallas/tvl1_pd.py:121")}
    rows = []
    for name in cuda.kernels():
        src, replaces = sources[name]
        s = summary[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": s["max_abs_err"],
                     "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
