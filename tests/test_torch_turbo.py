"""The port's production and turbo presets against the JAX package on the
CPU: the half-grid flow, the bf16 LF head, and ``run_clip`` against
``make_clip_fn`` at narrow width.

Tolerances, with their reasons:

- half-grid ``preprocess_pair`` in bf16: ``rgb_in`` equal; ``flow_in``
  within one bf16 step at its largest values (2^-6 for |x| in [2, 4)):
  the float32 flows differ within the 2e-4 TV-L1 band of
  ``tests/test_torch_pipeline.py`` (XLA contracts the solver's
  multiply-adds into FMAs), which can move a value across one bf16
  rounding boundary.
- bf16 modules: both sides round every activation to bf16 (8 bits of
  mantissa, relative step 2^-8 = 3.9e-3), but at different places (XLA
  may keep a fused intermediate in float32; PyTorch rounds each op's
  output), so outputs in [0, 1] are held to about one bf16 step: 5e-3.
- clips: heatmaps within 1e-2 (measured 1.1e-3 for both presets). In
  bf16 one rounding step of a logit near the sigmoid's centre moves the
  heatmap by about 1e-3; the int8 streams add a code flip wherever a
  bf16 input lands on the other side of a rounding boundary. Gaze is equal, or a near tie on the JAX heatmap:
  the port's pick within twice the measured heatmap difference of the
  JAX maximum.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu.models import quant as jquant
from gaze_tpu.models.lf import LateFusion as JLateFusion
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.models.pipeline import make_clip_fn
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch.models.lf import LateFusion
from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
from gaze_tpu_torch.models.quant_io import quant_sp_from_numpy
from gaze_tpu_torch.models.weights import lf_to_torch_state, load_state, torch_state_from_jax
from tests.test_torch_models import jax_variables, make_configs, t
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

FLOW_IN_BF16_BAND = 2.0**-6
BF16_BAND = 5e-3
CLIP_BAND = 1e-2
NEAR_TIE = 1e-5


def preset(jcfg, tcfg, name):
    """The JAX and port configs with ``PRESETS[name]``'s TV-L1 settings."""
    tcfg = tconfig.preset_config(name, tcfg)
    return dataclasses.replace(jcfg, tvl1=dataclasses.replace(
        jcfg.tvl1, **{k: getattr(tcfg.tvl1, k) for k in ("flow_scale", "warps", "iters")})), tcfg


@pytest.fixture(scope="module")
def narrow():
    jcfg, tcfg = make_configs()
    return jcfg, tcfg, jax_variables(jcfg)


def test_bf16_lf_matches_jax(narrow):
    """Measured 8.8e-4 from JAX's bf16 head, which is itself 9.1e-4 from
    the float32 head; the port's bf16 head must differ from its float32
    one too, so the dtype is applied."""
    jcfg, tcfg, v = narrow
    maps = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 2)).astype(np.float32)
    state = {k: t(a) for k, a in lf_to_torch_state(v["lf"]).items()}
    lf, lf32 = LateFusion(tcfg.lf, torch.bfloat16), LateFusion(tcfg.lf)
    load_state(lf, state)
    load_state(lf32, state)
    want = jax.jit(JLateFusion(jcfg.lf, dtype=jnp.bfloat16).apply)(
        v["lf"], jnp.asarray(maps, jnp.bfloat16))
    with torch.no_grad():
        got, got32 = lf(t(maps)), lf32(t(maps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_BAND)
    assert float((got - got32).abs().max()) > 1e-4


def clip_inputs():
    frames, _, _ = generate_sequence(SyntheticSpec(
        num_frames=8, height=64, width=64, seed=3, blob_sigma=4.0))
    frames = np.stack([frames[:4], frames[4:]])             # (2, 4, 64, 64, 3)
    fixsac = np.array([[0, 1, 1, 0], [1, 0, 1, 1]], np.float32)
    return frames, fixsac


@pytest.mark.parametrize("name", ["production", "turbo"])
def test_run_clip_matches_make_clip_fn(narrow, name):
    """B=2 streams x T=3 steps with fixation onsets, continued fixations
    and saccades. Turbo's int8 streams are the JAX package's calibration
    (three pairs of the clip, 99.9th percentile, bf16 stem) carried
    across, so both sides serve the same codes."""
    jcfg, tcfg, v = narrow
    jcfg, tcfg = preset(jcfg, tcfg, name)
    p = tconfig.PRESETS[name]
    frames, fixsac = clip_inputs()
    jp = JGazePipeline(jcfg, dtype=jnp.bfloat16)
    dtype = getattr(torch, p["dtype"])
    pairs = [(frames[:, i], frames[:, i + 1]) for i in range(3)]
    qsp = None
    if p["quant"]:
        # calibrate_pipeline_sp, with one compiled preprocess_pair serving
        # both the calibration batches and the half-grid check below
        pre = jax.jit(jp.preprocess_pair)
        batches = [pre(jnp.asarray(a), jnp.asarray(b), None) for a, b in pairs]
        jq = jquant.calibrate_sp(
            v["sp"]["params"], [np.asarray(r, np.float32) for r, _ in batches],
            [np.asarray(f, np.float32) for _, f in batches], 1.0, p["quant_percentile"],
            bf16_stem=p["quant_stem"] == "bf16")
        qsp = quant_sp_from_numpy(jax.tree.map(np.asarray, jq))
        want = batches[0]
        got = GazePipeline(tcfg, dtype=dtype, device="cpu").preprocess_pair(
            torch.from_numpy(pairs[0][0]), torch.from_numpy(pairs[0][1]))
        assert got[0].dtype == got[1].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want[0], np.float32))
        flow_want = np.asarray(want[1], np.float32)
        np.testing.assert_allclose(got[1].float().numpy(), flow_want, atol=FLOW_IN_BF16_BAND,
                                   rtol=0)
        assert np.abs(flow_want).max() > 0.01  # the flow moved
        jp = dataclasses.replace(jp, quant_sp=jq)
    j_hm, j_gaze = make_clip_fn(jp)(v, jnp.asarray(frames), jnp.asarray(fixsac))
    j_hm, j_gaze = np.asarray(j_hm), np.asarray(j_gaze)
    pipe = GazePipeline(tcfg, dtype=dtype, device="cpu", quant_sp=qsp)
    pipe.load_state_dicts(torch_state_from_jax(v))
    hm, gaze = run_clip(pipe, frames, fixsac)
    assert hm.shape == (2, 3, 64, 64) and gaze.shape == (2, 3, 2)
    assert hm.dtype == torch.float32
    diff = float(np.abs(hm.numpy() - j_hm).max())
    assert diff <= CLIP_BAND, diff
    tie = max(NEAR_TIE, 2 * diff)
    for b in range(2):
        for s in range(3):
            gx, gy = (int(c) for c in gaze[b, s])
            gap = float(j_hm[b, s].max() - j_hm[b, s, gy, gx])
            assert gap <= tie, (name, b, s, gaze[b, s].tolist(), j_gaze[b, s].tolist(), gap)
