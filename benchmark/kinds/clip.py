"""Offline batch inference: clips of B streams x T steps through
``run_clip``, back to back (a closed loop, one client).

Traffic parameters (``traffic/<mix>.json``): ``batch`` B, ``steps`` T
(a clip holds T + 1 frames), ``distinct_streams`` G (stream i of a clip
plays sequence i mod G, the layout of the JAX package's ``bench.py``),
``pool`` (distinct clips made in set-up from the seed; the window cycles
them, so every clip is uploaded again) and ``calibration_pairs`` (frame
pairs of the first clip's G sequences that calibrate int8 streams).

Correctness: the reference runs the pool's G distinct sequences once
each, in float32 and in the configuration's activation type. Every clip
of the window is judged by its gaze: at each stream and step, how far
the float32 reference's heatmap at the program's gaze lies below that
heatmap's maximum (``gaze_gap``). One completed occurrence of each pool
clip, drawn from the seed, keeps its heatmaps too: their mean distance
from the float32 reference beyond the bf16 reference's own, in units of
the latter (``heatmap_excess``, ``compare.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, faults, program, synthetic
from benchmark.reference import model as ref
from benchmark.weights import make_weights


def make_pool(run):
    tr, im = run.traffic, run.config["image"]
    B, T, G, P = tr["batch"], tr["steps"], tr["distinct_streams"], tr["pool"]
    seeds = synthetic.sequence_seeds(run.seed, P * G)
    clips = []
    for k in range(P):
        seqs = [synthetic.generate_sequence(T + 1, im["height"], im["width"], int(s))
                for s in seeds[k * G:(k + 1) * G]]
        rows = [i % G for i in range(B)]
        frames = np.stack([seqs[i][0] for i in rows])
        fix = np.stack([seqs[i][2] for i in rows])
        clips.append((frames, fix))
    return clips


def setup(run):
    cfg, tr = run.config, run.traffic
    dev = torch.device(run.device)
    if run.on_card:
        torch.cuda.set_device(0)
    with run.spans("setup.data"):
        st = {"clips": make_pool(run)}
    with run.spans("setup.weights"):
        st["weights"] = make_weights(cfg, run.seed, dev)
        run.sync()
    G = tr["distinct_streams"]
    first = st["clips"][0][0]
    st["calib"] = [(first[:G, t], first[:G, t + 1]) for t in range(tr["calibration_pairs"])]
    with run.spans("setup.program"):
        st["pipe"] = faults.plant(run.variant, program.served_pipeline(
            run, st["weights"], st["calib"], dev))
        run.sync()
    from gaze_tpu_torch.models.pipeline import run_clip

    st["run_clip"] = run_clip
    with run.spans("setup.warmup"):
        for k in range(min(2, len(st["clips"]))):      # every shape of the window, twice
            _, gz = run_clip(st["pipe"], *st["clips"][k])
            gz.cpu()
    rng = np.random.default_rng(run.seed)
    st["keep_at"] = rng.integers(0, 3, size=len(st["clips"])).tolist()
    return st


def _clip(run, st, n):
    """Clip ``n`` of the window: (pool index, gaze on the host, heatmaps)."""
    k = n % len(st["clips"])
    with run.spans("run_clip"):
        hm, gz = st["run_clip"](st["pipe"], *st["clips"][k])
    with run.spans("gaze_to_host"):
        gz = gz.cpu()
    return k, gz, hm


def window(run, st):
    tr = run.traffic
    done, kept = [], {}
    attempted = failed = 0
    t0 = time.perf_counter()
    n = 0
    while True:
        attempted += 1
        k, gz, hm = _clip(run, st, n)
        done.append((k, gz))
        j = n // len(st["clips"])
        if j <= st["keep_at"][k]:
            kept[k] = hm
        n += 1
        t1 = time.perf_counter()
        if t1 - t0 >= run.seconds:
            break
    st["done"], st["kept"] = done, kept
    frames = len(done) * tr["batch"] * tr["steps"]
    return {"frames_per_s": frames / (t1 - t0)}, attempted * tr["batch"], failed * tr["batch"]


def traced(run, st):
    run.trace_span(lambda: [_clip(run, st, i) for i in range(2)])
    return {"steps": 2 * run.traffic["steps"], "batch": run.traffic["batch"], "units": 2}


def release(run, st):
    st.pop("pipe", None)
    st.pop("run_clip", None)


def reference(run, st, dt=None):
    """The reference's heatmaps and gaze of the pool's distinct streams:
    the exact answer (float64 flow, float32 model), or at the stated
    precisions (float32 flow, the activation type ``dt``): (P * G, T, H,
    W), (P * G, T, 2)."""
    cfg, tr = run.config, run.traffic
    dev = torch.device(run.device)
    G = tr["distinct_streams"]
    ref.full_precision()
    frames = torch.cat([torch.from_numpy(f[:G]) for f, _ in st["clips"]]).to(dev)
    fix = torch.cat([torch.from_numpy(x[:G]) for _, x in st["clips"]]).to(dev)
    flow_dtype = torch.float64 if dt is None else torch.float32
    bounds = None
    if program.int8_streams(cfg):       # calibrated by the reference itself
        bounds = ref.calibrate_streams(
            st["weights"], [(torch.from_numpy(p).to(dev), torch.from_numpy(c).to(dev))
                            for p, c in st["calib"]], cfg, flow_dtype)
    return ref.run_clip(st["weights"], frames, fix, cfg, bounds, dt, flow_dtype)


def gaps(run, st, ref_hm, act_hm=None) -> dict:
    """The window's outputs against the float32 reference's heatmaps:
    ``gaze_gap`` (every clip), and over the kept clips ``heatmap_gap``
    (the largest pixel gap), ``heatmap_mean_gap`` (the largest mean pixel
    gap of a kept clip) and, given the reference's heatmaps in the
    activation type (``act_hm``), ``heatmap_excess``."""
    tr = run.traffic
    G, B = tr["distinct_streams"], tr["batch"]
    rows = torch.arange(B) % G
    T, H, W = ref_hm.shape[1:]
    flat = ref_hm.flatten(2).cpu()                       # (P*G, T, H*W)
    best = flat.amax(dim=2)
    steps = torch.arange(T)[None, :]
    out = {"gaze_gap": 0.0, "heatmap_gap": 0.0, "heatmap_mean_gap": 0.0}
    for k, gz in st["done"]:
        g = gz.round().long()
        if g.min() < 0 or g[..., 0].max() >= W or g[..., 1].max() >= H:
            return dict.fromkeys(out, float("inf"))
        r = (k * G + rows)[:, None]
        at = flat[r, steps, g[..., 1] * W + g[..., 0]]  # (B, T)
        out["gaze_gap"] = max(out["gaze_gap"], float((best[r, steps] - at).max()))
    g_prog = g_act = 0.0
    for k, hm in st["kept"].items():
        want = ref_hm[k * G + rows].to(hm.device)
        d = (hm.float() - want).abs()
        out["heatmap_gap"] = max(out["heatmap_gap"], float(d.max()))
        out["heatmap_mean_gap"] = max(out["heatmap_mean_gap"], float(d.mean()))
        g_prog += float(d.mean()) / len(st["kept"])
        if act_hm is not None:
            g_act += float((act_hm[k * G + rows].to(hm.device) - want).abs().mean()) / len(
                st["kept"])
    if act_hm is not None:
        run.readings.update(heatmap_gap_program=g_prog, heatmap_gap_stated=g_act)
        out["heatmap_excess"] = compare.excess(g_prog, g_act)
    return out


def check(run, st):
    ref_hm, _ = reference(run, st)
    dt = ref.act_dtype(run.config)
    act_hm = reference(run, st, dt)[0] if dt is not None else None
    got = gaps(run, st, ref_hm, act_hm)
    run.readings.update(heatmap_mean_gap=got["heatmap_mean_gap"], heatmap_gap=got["heatmap_gap"])
    return [(k, got.get(k, float("inf")), lim) for k, lim in run.limits.items()]
