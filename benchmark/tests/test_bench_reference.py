"""The plain reference against the program on the CPU at a tiny size,
float32 on both sides: the preprocessing and TV-L1, a whole clip, the int8
streams from their own calibration, the SP train step, and the server's
I-DT gating. The reference imports nothing of the program."""

import ast

import numpy as np
import pytest
import torch

from benchmark import harness, program, synthetic
from benchmark.reference import model as ref
from benchmark.tests.conftest import ROOT, load, tiny_config, tiny_spec
from benchmark.weights import make_weights

SEED = 2 ** 41 + 17


def cfg_of(name: str, **precision) -> dict:
    cfg = tiny_config(load(ROOT / "benchmark" / "configs" / f"{name}.json"))
    cfg["precision"].update(precision)
    return cfg


def frames(n_streams: int = 4, n_frames: int = 4):
    seqs = [synthetic.generate_sequence(n_frames, 48, 48, int(s))
            for s in synthetic.sequence_seeds(SEED, n_streams)]
    return np.stack([s[0] for s in seqs]), np.stack([s[2] for s in seqs]), np.stack(
        [s[1] for s in seqs])


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                for m in mods:
                    assert m.split(".")[0] in ("torch", "numpy", "math", "typing",
                                               "__future__"), (path.name, m)


@pytest.mark.parametrize("name", ["turbo", "production"])
def test_preprocess_and_flow_match(name):
    cfg = cfg_of(name)
    w = make_weights(cfg, SEED, "cpu")
    pipe = program.pipeline(dict(cfg, precision=dict(cfg["precision"], activations="float32")),
                            w, "cpu")
    f, _, _ = frames()
    rgb_p, flow_p = pipe.preprocess_pair(torch.from_numpy(f[:, 0]), torch.from_numpy(f[:, 1]))
    rgb_r, flow_r = ref.preprocess(torch.from_numpy(f[:, 0]), torch.from_numpy(f[:, 1]), cfg)
    assert torch.allclose(rgb_p.permute(0, 3, 1, 2), rgb_r, atol=1e-6)
    # the flow input is 8 px of motion per unit; TV-L1's branches agree to rounding
    assert float((flow_p.permute(0, 3, 1, 2) - flow_r).abs().max()) < 1e-4


def test_float_clip_matches():
    cfg = cfg_of("production", activations="float32", vgg_stem="float32", vgg="float32")
    w = make_weights(cfg, SEED, "cpu")
    pipe = program.pipeline(cfg, w, "cpu")
    f, fix, _ = frames(n_frames=5)
    from gaze_tpu_torch.models.pipeline import run_clip

    hm_p, gz_p = run_clip(pipe, f, fix)
    hm_r, gz_r = ref.run_clip(w, torch.from_numpy(f), torch.from_numpy(fix), cfg)
    assert float((hm_p - hm_r).abs().max()) < 1e-5
    assert torch.equal(gz_p, gz_r)


def test_int8_streams_match_from_their_own_calibration():
    """The int8 streams calibrated by each side from the same frames: the
    scales agree, the heatmaps differ only where a code rounds the other
    way (the program folds its epilogue in float32, the reference scales
    exact sums in float64)."""
    cfg = cfg_of("turbo", activations="float32")
    w = make_weights(cfg, SEED, "cpu")
    f, fix, _ = frames(n_frames=5)
    pairs = [(f[:, t], f[:, t + 1]) for t in range(2)]
    pipe = program.pipeline(cfg, w, "cpu")
    q = program.calibrate(cfg, pipe, pairs)
    bounds = ref.calibrate_streams(w, [(torch.from_numpy(a), torch.from_numpy(b))
                                       for a, b in pairs], cfg)
    for stream in ("spatial", "temporal"):
        for layer, s in getattr(q, stream).act_scales.items():
            want = bounds[stream][layer] / (127.0 if layer == "conv1_1" else 255.0)
            assert abs(float(s) - want) <= 1e-6 * want, (stream, layer)
    from gaze_tpu_torch.models.pipeline import run_clip

    hm_p, _ = run_clip(pipe.with_quant(q), f, fix)
    hm_r, _ = ref.run_clip(w, torch.from_numpy(f), torch.from_numpy(fix), cfg, bounds)
    d = (hm_p - hm_r).abs()
    assert float(d.mean()) < 1e-4 and float(d.max()) < 1e-2
    hm_float, _ = ref.run_clip(w, torch.from_numpy(f), torch.from_numpy(fix), cfg)
    assert float((hm_float - hm_r).abs().mean()) > 10 * float(d.mean())


def test_train_step_matches():
    """The program's float32 SP train step and the reference's: the loss,
    every leaf's gradient, the new parameters and statistics."""
    from gaze_tpu_torch.train.common import make_optimizer, make_state
    from gaze_tpu_torch.train.sp import make_sp_train_step

    cfg = cfg_of("production", activations="float32", vgg_stem="float32", vgg="float32")
    w = make_weights(cfg, SEED, "cpu")
    pipe = program.pipeline(cfg, w, "cpu")
    state = make_state(pipe.sp, make_optimizer(pipe.config.train))
    f, _, gaze = frames(n_streams=4, n_frames=3)
    batch = {"prev": f[:, 0], "cur": f[:, 1], "gaze": gaze[:, 1]}
    state, m = make_sp_train_step(pipe)(state, batch)
    r = ref.TrainRef(w["sp"], cfg)
    loss, g = r.step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - loss) <= 1e-5 * abs(loss)
    assert r.names == list(state.param_names)
    # a deconv's bias ahead of BatchNorm has a gradient of round-off alone
    med = float(np.median([float(g[n].norm()) for n in r.names]))
    kept = {n for n in r.names if float(g[n].norm()) >= 1e-3 * med}
    assert {n for n in r.names if n.startswith("decoder.deconv") and n.endswith("bias")} == set(
        r.names) - kept
    for name, mu in zip(state.param_names, state.opt_state.mu):
        if name in kept:
            assert float((mu / 0.1 - g[name]).norm()) <= 1e-3 * float(g[name].norm()), name
    sd = pipe.sp.state_dict()
    for k, v in r.w.items():
        if k in kept or not k.endswith("bias") or not k.startswith("decoder.deconv"):
            assert torch.allclose(sd[k], v, atol=1e-6, rtol=1e-4), k


def test_serve_gaze_is_what_the_reference_puts_first():
    """A float32 server, its I-DT fixations taken by the reference from
    the served gaze: every served gaze is the reference heatmap's top."""
    spec = tiny_spec("serve.turbo.s128")
    spec["config"]["precision"].update(activations="float32", vgg_stem="float32", vgg="float32")
    spec["traffic"]["rate_hz"] = 20.0
    # a float32 configuration has no lower activation type to measure an
    # excess against: its gaze and sentinels are what is held here
    spec["limits"].pop("heatmap_excess")
    r = harness.run_cell("serve.turbo.s128", SEED, 1.0, spec=spec, device="cpu")
    assert r["checks"]["sentinel_misses"]["value"] == 0.0
    assert r["checks"]["gaze_gap"]["value"] < 1e-5
    assert r["correct"]


def test_excess_is_what_the_program_adds_beyond_the_precision():
    from benchmark import compare

    assert compare.excess(0.5, 1.0) == 0.0
    assert compare.excess(1.0, 1.0) == 0.0
    assert abs(compare.excess(2.0, 1.0) - 3 ** 0.5) < 1e-12
    assert compare.excess(1.0, 0.0) == float("inf")
    assert compare.excess(float("nan"), 1.0) == float("inf")


@pytest.mark.parametrize("name", ["turbo", "production"])
def test_stated_precision_reference_is_as_far_from_exact_as_the_program(name):
    """The program's bf16 clip and the reference's own computation at the
    stated precisions lie about equally far from the exact reference
    (float64 flow, float32 model): the excess is small, and both lie
    measurably far from it."""
    from benchmark import compare
    from gaze_tpu_torch.models.pipeline import run_clip

    cfg = cfg_of(name)
    w = make_weights(cfg, SEED, "cpu")
    f, fix, _ = frames(n_frames=5)
    pairs = [(f[:, t], f[:, t + 1]) for t in range(2)]
    pipe = program.pipeline(cfg, w, "cpu")
    b64 = b32 = None
    if program.int8_streams(cfg):
        pipe = pipe.with_quant(program.calibrate(cfg, pipe, pairs))
        pairs_t = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in pairs]
        b64 = ref.calibrate_streams(w, pairs_t, cfg, torch.float64)
        b32 = ref.calibrate_streams(w, pairs_t, cfg)
    hm_p, _ = run_clip(pipe, f, fix)
    args = (w, torch.from_numpy(f), torch.from_numpy(fix), cfg)
    hm_32, _ = ref.run_clip(*args, b64, None, torch.float64)
    hm_16, _ = ref.run_clip(*args, b32, ref.act_dtype(cfg))
    g_p = float((hm_p.float() - hm_32).abs().mean())
    g_a = float((hm_16 - hm_32).abs().mean())
    assert g_a > 1e-5
    assert compare.excess(g_p, g_a) < 1.0, (g_p, g_a)
