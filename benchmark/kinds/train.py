"""The SP train step: ``train/sp.py:make_sp_train_step`` on batches of
distinct rows, back to back.

Traffic parameters (``traffic/<mix>.json``): ``batch`` B, ``pool``
batches made in set-up from ``sequences`` seeded sequences of
``frames_per_sequence`` frames (batch b holds frame pairs 2b and 2b + 1
of every sequence, so no two rows of the pool are alike), the gaze
target of each row its current frame's gaze; ``background_scales``: the
contrast of the scenes' texture, the sequences split into as many runs
of rows as it has entries (a batch that mixes low- and high-contrast
scenes has rows whose gradients differ in size, so a step on part of
the batch moves the gradient's norms).

Set-up builds one training state (the pipeline's SP and a fresh AdamW),
drives it through its first three steps on batches 0-2 through the same
call and feed as the window, and hands that state to the window, which
steps on from batch 3. ``samples_per_s`` is B times the steps of the
window over its seconds; the window ends in ``torch.cuda.synchronize()``.

Correctness: the float32 reference follows the first three steps from
the same weights and batches. Each step's loss (``loss_gap``, the worst
relative gap); the norm of the first gradient as the optimizer got it,
from Adam's first moment after step 1, per leaf; the norm of each leaf's
change over the three steps (``change_gap``, the worst leaf). A norm's
gap is taken against the reference's norm of that leaf or of the median
leaf, whichever is larger. The gradient is compared by the median leaf's
gap (``grad_median_gap``): the worst leaf's (``grad_gap``, kept as a
reading) swings from seed to seed with the bf16 rounding of the temporal
stream's early layers. Leaves whose reference gradient is under a
thousandth of the median leaf's (a deconv's bias ahead of BatchNorm) are
left out.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import program, synthetic
from benchmark.reference import model as ref
from benchmark.weights import make_weights

ADAM_B1 = 0.9
WARM_STEPS = 3


def make_batches(run):
    tr, im = run.traffic, run.config["image"]
    n_seq, nf, P = tr["sequences"], tr["frames_per_sequence"], tr["pool"]
    if n_seq * 2 != tr["batch"] or nf < 2 * P + 1:
        raise ValueError("a batch holds two frame pairs of every sequence")
    scales = tr.get("background_scales", [synthetic.BACKGROUND_SCALE])
    seqs = [synthetic.generate_sequence(nf, im["height"], im["width"], int(s),
                                        scales[i * len(scales) // n_seq])
            for i, s in enumerate(synthetic.sequence_seeds(run.seed, n_seq))]
    out = []
    for b in range(P):
        ts = (2 * b, 2 * b + 1)
        out.append({"prev": np.stack([s[0][t] for s in seqs for t in ts]),
                    "cur": np.stack([s[0][t + 1] for s in seqs for t in ts]),
                    "gaze": np.stack([s[1][t + 1] for s in seqs for t in ts])})
    return out


def plant(variant: str, step):
    """The train step with a planted fault (``faults.py``)."""
    if variant == "half_batch":
        def half(state, b):
            return step(state, {k: v[:len(v) // 2] for k, v in b.items()})
        return half
    if variant == "state_unchanged":
        def unchanged(state, b):
            keep = [p.detach().clone() for p in state.params]
            state, m = step(state, b)
            with torch.no_grad():
                for p, k in zip(state.params, keep):
                    p.copy_(k)
            return state, m
        return unchanged
    return step


def norms(tensors) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.float())) for t in tensors])


def setup(run):
    from gaze_tpu_torch.train.common import make_optimizer, make_state
    from gaze_tpu_torch.train.sp import make_sp_train_step

    cfg = run.config
    dev = torch.device(run.device)
    if run.on_card:
        torch.cuda.set_device(0)
    with run.spans("setup.data"):
        st = {"batches": make_batches(run)}
    with run.spans("setup.weights"):
        st["weights"] = make_weights(cfg, run.seed, dev)
        run.sync()
    with run.spans("setup.program"):
        pipe = program.pipeline(cfg, st["weights"], dev)
        state = make_state(pipe.sp, make_optimizer(pipe.config.train))
        step = plant(run.variant, make_sp_train_step(pipe))
        run.sync()
    names = st["names"] = list(state.param_names)
    losses = []
    if run.variant == "control":     # the reference at the lower precision in the program's place
        st.update(reference_readings(run, st, run.spec["control"]["reference_lowp"]))
    for b in range(WARM_STEPS):
        with run.spans("setup.first_steps"):
            state, m = step(state, st["batches"][b])
        losses.append(float(m["loss"]))
        if b == 0:
            grad = norms(mu / (1 - ADAM_B1) for mu in state.opt_state.mu)
    change = norms(p.detach() - st["weights"]["sp"][n] for n, p in zip(names, state.params))
    st.update(pipe=pipe, state=state, step=step)
    if run.variant != "control":
        st.update(losses=losses, grad=grad, change=change)
    return st


def _steps(run, st, first, count):
    P = len(st["batches"])
    for n in range(count):
        with run.spans("train_step"):
            st["state"], _ = st["step"](st["state"], st["batches"][(first + n) % P])


def window(run, st):
    B = run.traffic["batch"]
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < run.seconds:
        _steps(run, st, WARM_STEPS + n, 1)
        n += 1
    run.sync()
    t1 = time.perf_counter()
    st["n_steps"] = n
    return {"samples_per_s": n * B / (t1 - t0)}, n * B, 0


def traced(run, st):
    count = 2
    run.trace_span(lambda: _steps(run, st, WARM_STEPS + st["n_steps"], count))
    return {"steps": count, "batch": run.traffic["batch"], "units": count}


def release(run, st):
    for k in ("pipe", "state", "step"):
        st.pop(k, None)


def leaf_gaps(prog: np.ndarray, refn: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """|program norm - reference norm| of each kept leaf against the
    larger of its reference norm and the median kept leaf's."""
    med = float(np.median(refn[keep]))
    return np.abs(prog[keep] - refn[keep]) / np.maximum(refn[keep], med)


def reference_readings(run, st, lowp=None) -> dict:
    """The reference's first three steps: losses, the first gradient's
    and the change's norms per leaf."""
    dev = torch.device(run.device)
    ref.full_precision()
    r = ref.TrainRef(st["weights"]["sp"], run.config, lowp)
    if r.names != st["names"]:
        raise RuntimeError(f"leaves differ: {sorted(set(r.names) ^ set(st['names']))}")
    losses, grad = [], None
    w0 = {k: r.w[k] for k in r.names}
    for b in range(WARM_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in st["batches"][b].items()}
        loss, g = r.step(batch)
        losses.append(loss)
        if b == 0:
            grad = norms(g[k] for k in r.names)
        del g
    change = norms(r.w[k] - w0[k] for k in r.names)
    return {"losses": losses, "grad": grad, "change": change}


def check(run, st):
    rr = reference_readings(run, st)
    losses, grad, change = rr["losses"], rr["grad"], rr["change"]
    keep = grad >= 1e-3 * np.median(grad)
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(st["losses"], losses)]
    g_gaps, c_gaps = leaf_gaps(st["grad"], grad, keep), leaf_gaps(st["change"], change, keep)
    names = [n for n, k in zip(st["names"], keep) if k]
    for what, gaps in (("gradient", g_gaps), ("change", c_gaps)):
        worst = np.argsort(gaps)[::-1][:4]
        print("benchmark: worst leaves by " + what + ": " + ", ".join(
            f"{names[i]} {gaps[i]:.4g}" for i in worst), file=sys.stderr)
    got = {"loss_gap": max(loss_gaps), "grad_median_gap": float(np.median(g_gaps)),
           "change_gap": float(c_gaps.max()), "grad_gap": float(g_gaps.max())}
    run.readings.update({k: v for k, v in got.items() if k not in run.limits},
                        loss_gaps=loss_gaps)
    return [(k, got[k], lim) for k, lim in run.limits.items()]
