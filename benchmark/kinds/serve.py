"""Live tracking: a ``StreamServer`` with every slot attached, fed in an
open loop at a fixed tick rate.

Traffic parameters (``traffic/<mix>.json``): ``slots`` S, all attached;
``distinct_streams`` G and ``sequence_frames`` F (slot i plays sequence
i mod G, F frames long, from its first frame again after its last);
``rate_hz`` r (a frame for every slot is due every 1 / r seconds);
``idt_dispersion_px`` and ``idt_window`` (the server's online I-DT
fixations on its own predicted gaze); ``heatmap_ticks`` (how many ticks
the same server serves right after the window, at the same rate, with
its ``keep_heatmaps`` set so that they hand back their maps for the
check: the window itself reads back gaze alone);
``calibration_pairs`` (frame pairs of the G sequences that calibrate int8
streams); ``warmup_ticks`` (ticks of a throwaway server of the same size
in set-up).

Each tick's batch is handed to ``submit()`` at its due time, or as soon
as the previous call returns; ``flush()`` follows the last. ``submit()``
hands back the previous tick's result, so a frame's latency runs from
its due time to the return of the next call. ``tick_p95_ms`` is the
95th percentile of that latency over every tick due in the window.

Correctness: the program's first tick of every slot must be the (-1, -1)
sentinel (``sentinel_misses``, exact). The reference follows each slot
from its second tick with fresh state, its fixation bits worked out
from the program's served gaze by the same I-DT rule (the served gaze
plays the part of a served model's tokens), and every served gaze is
judged by how far the reference's heatmap at it lies below the
reference heatmap's maximum (``gaze_gap``). Slots that played the same
sequence and were served the same gaze share one reference row. The
heatmaps of the ticks after the window are held to the float32
reference's beyond the bf16 reference's own distance from it
(``heatmap_excess``, ``compare.py``): with random weights the served
gaze sits at the same few border pixels most of the time, so the gaze
alone cannot tell a lower precision from the stated one.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import compare, faults, program, synthetic
from benchmark.reference import model as ref
from benchmark.weights import make_weights


def setup(run):
    cfg, tr = run.config, run.traffic
    im = cfg["image"]
    dev = torch.device(run.device)
    if run.on_card:
        torch.cuda.set_device(0)
    G, F = tr["distinct_streams"], tr["sequence_frames"]
    with run.spans("setup.data"):
        seqs = [synthetic.generate_sequence(F, im["height"], im["width"], int(s))
                for s in synthetic.sequence_seeds(run.seed, G)]
        st = {"seqs": np.stack([s[0] for s in seqs]), "rows": np.arange(tr["slots"]) % G}
    with run.spans("setup.weights"):
        st["weights"] = make_weights(cfg, run.seed, dev)
        run.sync()
    st["calib"] = [(st["seqs"][:, t], st["seqs"][:, t + 1])
                   for t in range(tr["calibration_pairs"])]
    with run.spans("setup.program"):
        pipe = program.served_pipeline(run, st["weights"], st["calib"], dev)
        st["quant_sp"] = pipe.quant_sp
        del pipe
        run.sync()
    with run.spans("setup.warmup"):
        warm = server(run, st, dev)
        for n in range(tr["warmup_ticks"]):
            warm.submit(batch(st, n))
        warm.keep_heatmaps = True    # the maps' readback too
        warm.flush()
        del warm
        st["server"] = server(run, st, dev)
        st["sampled"] = set()
        faults.plant_server(run.variant, st["server"])
        run.sync()
    return st


def server(run, st, dev):
    from gaze_tpu_torch.serve import StreamServer

    cfg, tr = run.config, run.traffic
    srv = StreamServer(program.pipeline_config(cfg), st["weights"], tr["slots"],
                       dtype=program.dtype(cfg), fixation_source="idt",
                       idt_dispersion_px=tr["idt_dispersion_px"], idt_window=tr["idt_window"],
                       quant_sp=st["quant_sp"], device=dev)
    for i in range(tr["slots"]):
        srv.attach(i)
    return srv


def batch(st, n):
    """Tick ``n``'s frames: slot i's sequence at frame n mod F."""
    return st["seqs"][st["rows"], n % st["seqs"].shape[1]]


def ticks(run, st, first, count, out=None):
    """``count`` ticks due every 1 / r s from now, then a flush; returns
    (due, handed, returned) host times per tick. ``out`` collects each
    tick's gaze and ``st["maps"]`` the sampled ticks' heatmaps."""
    spans, srv = run.spans, st["server"]
    period = 1.0 / run.traffic["rate_hz"]
    due, handed, back = [], [], {}
    t0 = time.perf_counter()
    for n in range(count):
        d = t0 + n * period
        with spans("wait_due"):
            while True:
                left = d - time.perf_counter()
                if left <= 0:
                    break
                time.sleep(left - 0.0005 if left > 0.001 else 0)
        with spans("generate"):
            frames = batch(st, first + n)
        handed.append(time.perf_counter())
        due.append(d)
        srv.keep_heatmaps = first + n - 1 in st["sampled"]   # the tick this call produces
        with spans("submit"):
            r = srv.submit(frames)
        if r is not None:
            back[n - 1] = time.perf_counter()
            keep(st, out, first + n - 1, r)
    srv.keep_heatmaps = first + count - 1 in st["sampled"]
    with spans("flush"):
        r = srv.flush()
    back[count - 1] = time.perf_counter()
    keep(st, out, first + count - 1, r)
    return due, handed, back


def keep(st, out, n, r) -> None:
    """Tick ``n``'s gaze into ``out``, and its heatmaps where the tick is
    one the check samples."""
    if out is not None:
        out[n] = r["gaze"]
        if n in st["sampled"]:
            st["maps"][n] = r["heatmap"]


def window(run, st):
    tr = run.traffic
    n = int(math.ceil(run.seconds * tr["rate_hz"]))
    st["served"], st["maps"] = {}, {}
    due, handed, back = ticks(run, st, 0, n, st["served"])
    lat = [(back[i] - due[i]) * 1e3 for i in range(n) if i in back]
    st["lag_ms"] = [(h - d) * 1e3 for d, h in zip(due, handed)]
    st["tick_ms"] = lat
    p95 = float(np.percentile(np.asarray(lat, np.float64), 95))
    missing = n - len(lat)
    # after the window: the same streams go on, their maps handed back
    m = tr["heatmap_ticks"]
    st["sampled"] = set(range(n, n + m))
    ticks(run, st, n, m, st["served"])
    st["n_ticks"] = n + m
    return {"tick_p95_ms": p95}, n * tr["slots"], missing * tr["slots"]


def traced(run, st):
    count = 16
    run.trace_span(lambda: ticks(run, st, st["n_ticks"], count))
    return {"steps": count, "batch": run.traffic["slots"], "units": count,
            "lag_ms": st["lag_ms"], "tick_ms": st["tick_ms"]}


def release(run, st):
    st.pop("server", None)
    st.pop("quant_sp", None)


def idt_bits(hist: np.ndarray, dispersion: float) -> np.ndarray:
    """(S,) fixation bits from (S, window, 2) trailing gaze, NaN where
    there is no sample: a full window whose x-extent plus y-extent is
    within ``dispersion``."""
    full = ~np.isnan(hist).any(axis=(1, 2))
    ext = np.nan_to_num(hist.max(axis=1) - hist.min(axis=1), nan=np.inf)
    return (full & (ext[:, 0] + ext[:, 1] <= dispersion)).astype(np.float32)


def check(run, st):
    cfg, tr = run.config, run.traffic
    dev = torch.device(run.device)
    served, N, S = st["served"], st["n_ticks"], tr["slots"]
    if len(served) < N:
        return [(k, float("inf"), lim) for k, lim in run.limits.items()]
    gz = np.stack([served[n] for n in range(N)], axis=1)          # (S, N, 2)
    misses = int((gz[:, 0] != -1.0).any(axis=1).sum()) + int((gz[:, 1:] < 0).any(axis=2).sum())
    # the server's I-DT window: the sentinel and the missing are NaN
    hist = np.where(gz[:, :, :1] < 0, np.nan, gz).astype(np.float64)
    wdw = tr["idt_window"]
    pad = np.full((S, wdw, 2), np.nan)
    hist = np.concatenate([pad, hist], axis=1)                    # tick n's window: n .. n+wdw
    fix = np.stack([idt_bits(hist[:, n:n + wdw], tr["idt_dispersion_px"]) for n in range(N)],
                   axis=1)                                          # (S, N)
    keys = {}
    for i in range(S):
        keys.setdefault((int(st["rows"][i]), gz[i].tobytes()), []).append(i)
    lead = [g[0] for g in keys.values()]
    dt = ref.act_dtype(cfg)
    sal, feat = reference_sp(run, st)
    sal_a, feat_a = reference_sp(run, st, dt) if dt is not None else (None, None)
    seq = torch.as_tensor(st["rows"][lead], device=dev)
    fix_t = torch.from_numpy(fix[lead]).to(dev)
    want = torch.from_numpy(gz[lead]).round().long().to(dev)
    F, W = st["seqs"].shape[1], cfg["image"]["width"]
    group = np.zeros(S, np.int64)
    for j, members in enumerate(keys.values()):
        group[members] = j
    state = ref.init_state(len(lead), cfg, dev)
    state_a = ref.init_state(len(lead), cfg, dev)
    got = {"sentinel_misses": float(misses), "gaze_gap": 0.0, "heatmap_gap": 0.0,
           "heatmap_mean_gap": 0.0}
    g_prog = g_act = 0.0
    rows_of = torch.from_numpy(group).to(dev)
    with torch.no_grad():
        for n in range(1, N):
            state, hm, _ = ref.attend(st["weights"], state, sal[seq, n % F], feat[seq, n % F],
                                      fix_t[:, n], cfg)
            flat = hm.flatten(1)
            at = flat.gather(1, (want[:, n, 1] * W + want[:, n, 0])[:, None])[:, 0]
            got["gaze_gap"] = max(got["gaze_gap"], float((flat.amax(dim=1) - at).max()))
            if dt is not None:
                state_a, hm_a, _ = ref.attend(st["weights"], state_a, sal_a[seq, n % F],
                                              feat_a[seq, n % F], fix_t[:, n], cfg, dt)
            if n in st["maps"]:
                d = (torch.from_numpy(st["maps"][n]).to(dev).float() - hm[rows_of]).abs()
                got["heatmap_gap"] = max(got["heatmap_gap"], float(d.max()))
                got["heatmap_mean_gap"] = max(got["heatmap_mean_gap"], float(d.mean()))
                g_prog += float(d.mean()) / len(st["maps"])
                if dt is not None:
                    g_act += float((hm_a - hm)[rows_of].abs().mean()) / len(st["maps"])
    if dt is not None and st["maps"]:
        run.readings.update(heatmap_gap_program=g_prog, heatmap_gap_stated=g_act)
        got["heatmap_excess"] = compare.excess(g_prog, g_act)
    run.readings.update(heatmap_mean_gap=got["heatmap_mean_gap"], heatmap_gap=got["heatmap_gap"])
    return [(k, got.get(k, float("inf")), lim) for k, lim in run.limits.items()]


@torch.no_grad()
def reference_sp(run, st, dt=None, block: int = 64):
    """The reference's saliency and spatial conv5 of every frame pair a
    slot can see, exact (float64 flow, float32 model) or at the stated
    precisions (float32 flow, the activation type ``dt``): (G, F, H, W)
    and (G, F, C, h, w), pair c being frames
    (c - 1) mod F and c of a sequence. SP needs no recurrent state, so it
    runs in blocks of pairs; the AT and LF recurrence then runs tick by
    tick."""
    cfg = run.config
    dev = torch.device(run.device)
    ref.full_precision()
    flow_dtype = torch.float64 if dt is None else torch.float32
    bounds = None
    if program.int8_streams(cfg):
        bounds = ref.calibrate_streams(
            st["weights"], [(torch.from_numpy(p).to(dev), torch.from_numpy(c).to(dev))
                            for p, c in st["calib"]], cfg, flow_dtype)
    seqs = torch.from_numpy(st["seqs"])
    G, F = seqs.shape[:2]
    cur = [(g, c) for g in range(G) for c in range(F)]
    sal, feat = [], []
    for i in range(0, len(cur), block):
        part = cur[i:i + block]
        prev_f = torch.stack([seqs[g, (c - 1) % F] for g, c in part]).to(dev)
        cur_f = torch.stack([seqs[g, c] for g, c in part]).to(dev)
        rgb, flow = ref.preprocess(prev_f, cur_f, cfg, flow_dtype)
        s, f = ref.sp_forward(st["weights"], rgb, flow, cfg, bounds, dt)
        sal.append(s)
        feat.append(f)
    sal, feat = torch.cat(sal), torch.cat(feat)
    return sal.view(G, F, *sal.shape[1:]), feat.view(G, F, *feat.shape[1:])
