"""The port's per-frame step and clip runner against the JAX pipeline on
the CPU: the committed parity goldens at 32² and 224² (full VGG16 width),
and ``run_clip`` against ``make_clip_fn`` over a clip with fixation
onsets.

Tolerances. The goldens' own is 1e-5 (atol and rtol), held on seven of
the eight keys, with ``gaze_xy`` equal. ``flow_in`` — the TV-L1 flow,
clipped and scaled by 1/(15·2·0.226) — has a stated band of 2e-4: XLA
compiles the JAX solver's primal-dual scan body with its multiply-adds
contracted into FMAs (measured on this CPU: the residual
``rho_c + i1wx*u1 + i1wy*u2`` matches a nested FMA bit for bit), the
port rounds every operation as the scan body is written (and so as the
CUDA kernel does), and 4 levels x 5 warps x 10 iterations with medians
carry those ulps to 1.3e-4 at 224² (9e-4 px of flow). The temporal VGG
stream absorbs it: saliency and everything after stay within 1e-5.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu.evaluation.goldens import _golden_setup, load_goldens
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.models.pipeline import make_clip_fn
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch.models.at import fixation_pool
from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.ops.heatmap import heatmap_argmax
from tests.test_torch_models import jax_variables, make_configs
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

GOLDEN_TOL = 1e-5
FLOW_IN_BAND = 2e-4


def port_config(cfg):
    """A JAX config tree as the port's dataclasses (shared fields only)."""

    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                v = conv(v, type(getattr(cls(), f.name)))
            kw[f.name] = v
        return cls(**kw)

    return conv(cfg, tconfig.PipelineConfig)


@pytest.fixture(scope="module")
def golden_variables():
    """``GazePipeline(cfg).init_variables(jax.random.key(0))`` — the
    goldens' parameters. Their shapes, and so their values, do not depend
    on the image size, so one jit-compiled init at 32² serves both."""
    cfg, _ = _golden_setup("tiny")
    v = jax.jit(JGazePipeline(cfg).init_variables)(jax.random.key(0))
    return torch_state_from_jax(jax.tree.map(np.asarray, v))


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_step_reproduces_parity_goldens(size, golden_variables):
    cfg, batch = _golden_setup(size)
    pcfg = port_config(cfg)
    pipe = GazePipeline(pcfg, device="cpu")
    pipe.load_state_dicts(golden_variables)
    # the serving frames of gaze_tpu/evaluation/goldens.py:101-111
    frames, _, _ = generate_sequence(SyntheticSpec(
        num_frames=batch + 1, height=cfg.image.height, width=cfg.image.width, seed=7))
    prev = torch.from_numpy(frames[:batch])
    cur = torch.from_numpy(frames[1 : batch + 1])
    fix = torch.ones(batch)
    with torch.inference_mode():
        rgb_in, flow_in = pipe.preprocess_pair(prev, cur)
        sal, feat = pipe.sp_forward(rgb_in, flow_in)
        w = fixation_pool(feat, heatmap_argmax(sal), pcfg.at)
        _, out = pipe.step(pipe.init_state(batch), prev, cur, fix)
    got = {
        "rgb_in": rgb_in, "flow_in": flow_in, "sp_saliency": out["saliency"],
        "sp_conv5": feat, "at_weights": w, "at_attention": out["attention"],
        "lf_heatmap": out["heatmap"], "gaze_xy": out["gaze"],
    }
    golden = load_goldens(os.path.join(os.path.dirname(__file__), "goldens",
                                       f"parity_{size}.npz"))
    assert set(got) == set(golden)
    for k, g in golden.items():
        a = got[k].numpy()
        assert a.shape == g.shape, k
        if k == "gaze_xy":
            np.testing.assert_array_equal(a, g)
        elif k == "flow_in":
            np.testing.assert_allclose(a, g, atol=FLOW_IN_BAND, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(a, g, atol=GOLDEN_TOL, rtol=GOLDEN_TOL, err_msg=k)


def test_run_clip_matches_make_clip_fn():
    """B=2 streams x T=3 steps at narrow width, with fixation onsets,
    continued fixations and saccades, so the onset gate both steps and
    holds the LSTM. make_clip_fn is jit-compiled: XLA also contracts the
    warp and the model's elementwise tails into FMAs, so heatmaps are
    held to 1e-4; gaze must be equal."""
    jcfg, tcfg = make_configs()
    v = jax_variables(jcfg)
    frames, _, _ = generate_sequence(SyntheticSpec(
        num_frames=8, height=64, width=64, seed=3, blob_sigma=4.0))
    frames = np.stack([frames[:4], frames[4:]])             # (2, 4, 64, 64, 3)
    fixsac = np.array([[0, 1, 1, 0], [1, 0, 1, 1]], np.float32)
    j_hm, j_gaze = make_clip_fn(JGazePipeline(jcfg))(
        v, jnp.asarray(frames), jnp.asarray(fixsac))
    pipe = GazePipeline(tcfg, device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(v))
    hm, gaze = run_clip(pipe, frames, fixsac)
    assert hm.shape == (2, 3, 64, 64) and gaze.shape == (2, 3, 2)
    np.testing.assert_allclose(hm.numpy(), np.asarray(j_hm), atol=1e-4)
    np.testing.assert_array_equal(gaze.numpy(), np.asarray(j_gaze))
