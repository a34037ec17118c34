"""The pipeline's inference options against the JAX pipeline on the CPU.

- ``flow_img``: a precomputed flow image, larger than the model grid so
  that its resize shrinks (the antialiased resize), in place of the
  TV-L1 solve; also as the third member of calibration triples.
- ``at_pool="prediction"``: AT pools at the previous frame's gaze.
- ``decoder_impl="pixelshuffle"`` and ``"halfres"``
  (``models/decode_fast.py``), BatchNorm folded with random statistics.

Each option runs T=3 steps of B=2 streams with fixation onsets, holds
and saccades, at a narrow 32² width with ``roi_size=1`` (a wider ROI
covers the whole 2x2 conv5 grid, so the pooling point would not
matter). Every step feeds flow images, so JAX compiles no TV-L1 solve.
Tolerance: float32 convolutions summed in another order, 1e-5 on every
map; gaze equal. Each option is also shown to change the port's output
against the default, so the comparison has teeth.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.models import quant as jquant
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu_torch.models import quant
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import torch_state_from_jax
from tests.test_torch_models import jax_variables, make_configs
from tests.test_torch_quant import SCALE_RTOL, assert_scales_close
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

TOL = 1e-5
B, T, SIZE = 2, 3, 32
OPTIONS = {
    "flow_img": {},
    "at_pool_prediction": dict(at_pool="prediction"),
    "pixelshuffle": dict(decoder_impl="pixelshuffle"),
    "halfres": dict(decoder_impl="halfres"),
}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = make_configs(image=dict(height=SIZE, width=SIZE), at=dict(roi_size=1))
    v = jax_variables(jcfg)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (B, T + 1, SIZE, SIZE, 3), np.uint8)
    flows = rng.integers(0, 256, (B, T, 48, 40, 2), np.uint8)
    fix = np.array([[0, 1, 1, 0], [1, 1, 0, 1]], np.float32)
    return jcfg, tcfg, v, frames, flows, fix


def port_steps(tcfg, v, frames, flows, fix, **opt):
    pipe = GazePipeline(tcfg, device="cpu", **opt)
    pipe.load_state_dicts(torch_state_from_jax(v))
    state, outs = pipe.init_state(B), []
    for t in range(T):
        state, out = pipe.step(state, frames[:, t], frames[:, t + 1], fix[:, t + 1],
                               flow_img=flows[:, t])
        outs.append(out)
    return outs


@pytest.mark.parametrize("name", list(OPTIONS))
def test_step_option_matches_jax(name, setup):
    jcfg, tcfg, v, frames, flows, fix = setup
    opt = OPTIONS[name]
    jp = JGazePipeline(jcfg, **opt)
    step = jax.jit(lambda s, p, c, f, fl: jp.step(v, s, p, c, f, flow_img=fl))
    state = jp.init_state(B)
    got = port_steps(tcfg, v, frames, flows, fix, **opt)
    for t in range(T):
        state, want = step(state, jnp.asarray(frames[:, t]), jnp.asarray(frames[:, t + 1]),
                           jnp.asarray(fix[:, t + 1]), jnp.asarray(flows[:, t]))
        for k in ("saliency", "attention", "heatmap"):
            np.testing.assert_allclose(got[t][k].numpy(), np.asarray(want[k]), atol=TOL,
                                       rtol=TOL, err_msg=f"{name} t={t} {k}")
        np.testing.assert_array_equal(got[t]["gaze"].numpy(), np.asarray(want["gaze"]))
    if opt:   # teeth: the option changes what the port computes
        base = port_steps(tcfg, v, frames, flows, fix)
        key = "attention" if "at_pool" in opt else "saliency"
        assert max(float((g[key] - b[key]).abs().max()) for g, b in zip(got, base)) > 0


def test_flow_img_skips_the_solve_and_shrinks_antialiased(setup):
    """The flow image is resized as pixels, antialiased when it shrinks,
    and the frame pair's motion plays no part."""
    jcfg, tcfg, v, frames, flows, fix = setup
    pipe = GazePipeline(tcfg, device="cpu")
    other = np.roll(frames[:, 0], 5, axis=2)
    a = pipe.preprocess_pair(torch.from_numpy(frames[:, 0]), torch.from_numpy(frames[:, 1]),
                             torch.from_numpy(flows[:, 0]))
    b = pipe.preprocess_pair(torch.from_numpy(other), torch.from_numpy(frames[:, 1]),
                             torch.from_numpy(flows[:, 0]))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    q = flows[:, 0].astype(np.float32) / 255.0
    want = (np.asarray(jax.image.resize(q, (B, SIZE, SIZE, 2), "bilinear")) - 0.5) / 0.226
    np.testing.assert_allclose(a[1].numpy(), want, atol=TOL, rtol=TOL)


def test_calibration_takes_flow_image_triples(setup):
    """``calibrate_pipeline_sp`` with (prev, cur, flow_img) triples: both
    streams' scales within 1e-6 of JAX's, as with the same inputs."""
    jcfg, tcfg, v, frames, flows, _ = setup
    triples = [(frames[:, t], frames[:, t + 1], flows[:, t]) for t in range(2)]
    jp = JGazePipeline(jcfg)
    pipe = GazePipeline(tcfg, device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(v))
    want = jquant.calibrate_pipeline_sp(jp, v, triples, percentile=99.9)
    got = quant.calibrate_pipeline_sp(pipe, triples, percentile=99.9)
    assert_scales_close(got.spatial.act_scales, want.spatial.act_scales, SCALE_RTOL)
    assert_scales_close(got.temporal.act_scales, want.temporal.act_scales, SCALE_RTOL)
