"""The port's sequential rollout (``rollout_eval_arrays``) against the
JAX package's on the CPU: V=2 synthetic videos x T=9 frames at 32²,
narrow widths, the same weights through the bridge.

Video 1 has two untracked frames (valid 0) whose gaze is NaN, so the
masking must use ``where``. Counts are equal. Bands, per scored frame:
AAE within 1e-4 degrees and AUC within 1/(H·W) (one pixel crossing a
tie). At this grid one pixel of gaze is about 2.6 degrees, so the AAE
band admits no gaze that differs from JAX's. The port's sums do not
depend on ``chunk_len`` at all (float64, in frame order).
"""

import numpy as np
import pytest

import jax

from gaze_tpu.evaluation.rollout import rollout_eval_arrays as jax_rollout
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import torch_state_from_jax
from tests.test_torch_models import jax_variables, make_configs
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

V, T, SIZE = 2, 9, 32
AAE_BAND = 1e-4               # degrees per scored frame
AUC_BAND = 1.0 / (SIZE * SIZE)  # per scored frame


@pytest.fixture(scope="module")
def corpus():
    jcfg, tcfg = make_configs(image=dict(height=SIZE, width=SIZE),
                              tvl1=dict(pyramid_levels=2, warps=1, iters=3))
    v = jax_variables(jcfg)
    pipe = GazePipeline(tcfg, device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(v))
    seqs = [generate_sequence(SyntheticSpec(num_frames=T, height=SIZE, width=SIZE, seed=s,
                                            blob_sigma=3.0, fixation_len=3))
            for s in range(V)]
    frames, gaze, fixsac = (np.stack(x) for x in zip(*seqs))
    valid = np.ones((V, T), np.float32)
    valid[1, 3:5] = 0.0
    gaze[1, 3:5] = np.nan
    flow = np.random.default_rng(9).integers(0, 256, (V, T, 40, 36, 2), np.uint8)
    return JGazePipeline(jcfg), v, pipe, frames, gaze, fixsac, valid, flow


@pytest.fixture(scope="module")
def port_sums(corpus):
    """The port's sums at two chunk lengths, shared by the tests below."""
    _, _, pipe, frames, gaze, fixsac, valid, _ = corpus
    return {n: rollout_eval_arrays(pipe, frames, gaze, fixsac, valid, chunk_len=n)
            for n in (3, 8)}


def assert_sums_close(got, want):
    g_aae, g_auc, g_cnt = got
    w_aae, w_auc, w_cnt = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(g_cnt, w_cnt)
    np.testing.assert_allclose(g_aae, w_aae, atol=AAE_BAND * g_cnt.max(), rtol=0)
    np.testing.assert_allclose(g_auc, w_auc, atol=AUC_BAND * g_cnt.max(), rtol=0)
    assert np.isfinite(g_aae).all() and np.isfinite(g_auc).all()


@pytest.mark.parametrize("chunk_len", [3, 8])
def test_rollout_matches_jax(chunk_len, corpus, port_sums):
    """Through TV-L1, the last chunk padded at chunk_len 3 (8 frames)."""
    jp, v, _, frames, gaze, fixsac, valid, _ = corpus
    got = port_sums[chunk_len]
    assert_sums_close(got, jax_rollout(jp, v, frames, gaze, fixsac, valid, chunk_len=chunk_len))
    np.testing.assert_array_equal(got[2], [8.0, 6.0])   # 2 untracked frames
    # the same frames, the same sums, whatever the chunking
    for a, b in zip(port_sums[3], port_sums[8]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("score_key", ["heatmap", "saliency", "attention"])
def test_rollout_scores_each_map_from_flow_images(score_key, corpus):
    """The flow-image path (no TV-L1 solve), each of the three maps."""
    jp, v, pipe, frames, gaze, fixsac, valid, flow = corpus
    got = rollout_eval_arrays(pipe, frames, gaze, fixsac, valid, chunk_len=5,
                              score_key=score_key, flow_img=flow)
    want = jax_rollout(jp, v, frames, gaze, fixsac, valid, chunk_len=5, score_key=score_key,
                       flow_img=flow)
    assert_sums_close(got, want)


def test_single_frame_and_empty_videos_score_nothing(corpus):
    jp, v, pipe, frames, gaze, fixsac, valid, _ = corpus
    got = rollout_eval_arrays(pipe, frames[:, :1], gaze[:, :1], fixsac[:, :1])
    want = jax_rollout(jp, v, frames[:, :1], gaze[:, :1], fixsac[:, :1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.shape == (V,) and not a.any()
    for a in rollout_eval_arrays(pipe, frames[:, :0], gaze[:, :0], fixsac[:, :0]):
        assert a.shape == (V,) and not a.any()


def test_rollout_rejects_unknown_score_key(corpus):
    _, _, pipe, frames, gaze, fixsac, _, _ = corpus
    with pytest.raises(ValueError):
        rollout_eval_arrays(pipe, frames, gaze, fixsac, score_key="final")
    with pytest.raises(ValueError):
        jax_rollout(corpus[0], corpus[1], frames, gaze, fixsac, score_key="final")
    assert jax.devices()[0].platform == "cpu"
