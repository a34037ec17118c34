"""The port's evaluation metrics, losses and host data against the JAX
package on the CPU.

Tolerances, on identical float32 inputs:
- AUC equal: it counts exact ties and strict comparisons, and divides by
  H·W as the compiled JAX function does;
- AAE within 1e-4 degrees (float32 ray arithmetic in another order);
- losses within 1e-6 relative;
- the synthetic corpus and the I-DT labels equal, byte for byte.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.core import config as jconfig
from gaze_tpu.data import fixation as jfix
from gaze_tpu.data import synthetic as jsyn
from gaze_tpu.evaluation import losses as jlosses
from gaze_tpu.evaluation import metrics as jmetrics
from gaze_tpu.models.lf import LateFusion as JLateFusion
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch.data import fixation as tfix
from gaze_tpu_torch.data import synthetic as tsyn
from gaze_tpu_torch.evaluation import losses as tlosses
from gaze_tpu_torch.evaluation import metrics as tmetrics
from gaze_tpu_torch.models.lf import LateFusion
from gaze_tpu_torch.models.weights import lf_to_torch_state, load_state
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

AAE_TOL = 1e-4      # degrees
LOSS_RTOL = 1e-6
CAMERAS = ("gtea_gaze_plus", "gtea_gaze")


def scored_inputs(seed=0, B=24, H=24, W=32):
    """Heatmaps with many exact ties (values on a 1/8 grid in half the
    frames), GT points inside, on half-pixel centres (round half to even)
    and outside the grid (clipped)."""
    rng = np.random.default_rng(seed)
    hm = rng.random((B, H, W)).astype(np.float32)
    hm[: B // 2] = np.round(hm[: B // 2] * 8) / 8
    gt = rng.uniform(0, [W - 1, H - 1], (B, 2)).astype(np.float32)
    gt[0], gt[1], gt[2], gt[3] = [3.5, 2.5], [4.5, 7.5], [-3.0, 40.0], [W + 5.0, -0.4]
    return hm, gt


@pytest.mark.parametrize("camera", CAMERAS)
def test_metrics_match_jax(camera):
    hm, gt = scored_inputs()
    jcam, tcam = getattr(jconfig.CameraConfig, camera)(), getattr(tconfig.CameraConfig, camera)()
    want_aae, want_auc = jax.jit(lambda h, g: (jmetrics.aae(h, g, jcam),
                                               jmetrics.auc_judd(h, g)))(hm, gt)
    got_aae, got_auc = tmetrics.compute_aae_auc(torch.from_numpy(hm), torch.from_numpy(gt), tcam)
    np.testing.assert_array_equal(got_auc.numpy(), np.asarray(want_auc))
    np.testing.assert_allclose(got_aae.numpy(), np.asarray(want_aae), atol=AAE_TOL, rtol=0)
    rays = tmetrics.pixel_to_ray(torch.from_numpy(gt), (24, 32), tcam).numpy()
    np.testing.assert_allclose(rays, np.asarray(jmetrics.pixel_to_ray(gt, (24, 32), jcam)),
                               atol=1e-6, rtol=0)


def test_the_jax_default_metric_pair_matches():
    """``compute_aae_auc`` of both packages with their default camera."""
    hm, gt = scored_inputs(seed=1, H=32, W=32)
    want_aae, want_auc = jmetrics.compute_aae_auc(jnp.asarray(hm), jnp.asarray(gt))
    got_aae, got_auc = tmetrics.compute_aae_auc(torch.from_numpy(hm), gt)
    np.testing.assert_array_equal(got_auc.numpy(), np.asarray(want_auc))
    np.testing.assert_allclose(got_aae.numpy(), np.asarray(want_aae), atol=AAE_TOL, rtol=0)


def test_auc_tie_convention_and_aae_zero():
    """A strict maximum at the GT pixel scores 1 - 0.5/(H·W) (the GT
    pixel counts in its own tie set and in the denominator); a flat map
    scores 0.5; the argmax at the GT pixel gives AAE 0."""
    H, W = 8, 10
    hm = np.zeros((2, H, W), np.float32)
    hm[0, 3, 4] = 1.0
    gt = np.array([[4.0, 3.0], [1.0, 1.0]], np.float32)
    a, u = tmetrics.compute_aae_auc(torch.from_numpy(hm), gt)
    # the reciprocal of H·W is rounded to float32: within one ulp
    assert abs(float(u[0]) - (1 - 0.5 / (H * W))) <= 2 ** -24
    assert abs(float(u[1]) - 0.5) <= 2 ** -24
    assert float(a[0]) == 0.0


def test_half_pixel_gt_rounds_half_to_even():
    """GT x = 2.5 scores pixel 2, x = 3.5 pixel 4 (round half to even)."""
    hm = np.zeros((2, 1, 6), np.float32)
    hm[:, 0, 2] = 1.0
    gt = np.array([[2.5, 0.0], [3.5, 0.0]], np.float32)
    u = tmetrics.auc_judd(torch.from_numpy(hm), torch.from_numpy(gt)).numpy()
    np.testing.assert_array_equal(u, np.asarray(jax.jit(jmetrics.auc_judd)(hm, gt)))
    assert u[0] > 0.9 > 0.5 > u[1]


def test_bf16_heatmaps_are_float32_in_both_packages():
    """On the bf16 path the LF head's sigmoid runs on float32 logits in
    both packages, so AUC compares float32 heatmaps whose ties come from
    the bf16 logits, and both count the same ties."""
    jcfg, tcfg = jconfig.LFConfig(channels=(4,)), tconfig.LFConfig(channels=(4,))
    maps = np.random.default_rng(2).random((3, 16, 16, 2)).astype(np.float32)
    jlf = JLateFusion(jcfg, dtype=jnp.bfloat16)
    v = jax.tree.map(np.asarray, jlf.init(jax.random.key(1), jnp.asarray(maps)))
    want = jlf.apply(v, jnp.asarray(maps))
    lf = LateFusion(tcfg, torch.bfloat16).eval()
    load_state(lf, {k: torch.from_numpy(a) for k, a in lf_to_torch_state(v).items()})
    with torch.no_grad():
        got = lf(torch.from_numpy(maps))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert len(np.unique(got.numpy())) < 0.6 * got.numel()    # bf16 logits: many ties
    gt = np.array([[3.0, 4.0], [8.0, 8.0], [15.0, 0.0]], np.float32)
    # on the same float32 heatmap, the two AUCs are equal
    np.testing.assert_array_equal(
        tmetrics.auc_judd(got, torch.from_numpy(gt)).numpy(),
        np.asarray(jax.jit(jmetrics.auc_judd)(got.numpy(), gt)))


@pytest.mark.parametrize("name", ["floss", "floss_weighted", "bce", "mse"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (4, 12, 12)).astype(np.float32)
    pred[0, 0, :3] = [0.0, 1.0, 1e-9]          # the eps clip
    target = rng.uniform(0, 1, (4, 12, 12)).astype(np.float32)
    w = np.array([1.0, 0.0, 0.5, 1.0], np.float32)
    cfg_j, cfg_t = jconfig.LossConfig(gamma=2.0), tconfig.LossConfig(gamma=2.0)
    p, tg = torch.from_numpy(pred), torch.from_numpy(target)
    if name == "floss":
        got, want = tlosses.floss(p, tg, cfg_t), jlosses.floss(pred, target, cfg_j)
    elif name == "floss_weighted":
        got = tlosses.floss(p, tg, cfg_t, torch.from_numpy(w))
        want = jlosses.floss(pred, target, cfg_j, jnp.asarray(w))
    elif name == "bce":
        got, want = tlosses.bce(p, tg), jlosses.bce(pred, target)
    else:
        got, want = tlosses.mse(p, tg), jlosses.mse(pred, target)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("num_blobs", [1, 3])
def test_synthetic_corpus_is_the_jax_one(num_blobs):
    """Same seed, same frames, gaze and bits; and the same clip and
    batch iterators."""
    spec = dict(num_frames=14, height=24, width=28, seed=4, blob_sigma=3.0, num_blobs=num_blobs)
    for a, b in zip(tsyn.generate_sequence(tsyn.SyntheticSpec(**spec)),
                    jsyn.generate_sequence(jsyn.SyntheticSpec(**spec))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    kw = dict(batch_size=3, num_batches=2, seed=1, num_videos=2)
    for it_t, it_j in ((tsyn.clip_iterator(tsyn.SyntheticSpec(**spec), clip_len=4, **kw),
                        jsyn.clip_iterator(jsyn.SyntheticSpec(**spec), clip_len=4, **kw)),
                       (tsyn.batch_iterator(tsyn.SyntheticSpec(**spec), **kw),
                        jsyn.batch_iterator(jsyn.SyntheticSpec(**spec), **kw))):
        for bt, bj in zip(it_t, it_j):
            assert bt.keys() == bj.keys()
            for k in bt:
                assert np.array_equal(bt[k], bj[k]), k
    assert dataclasses.asdict(tsyn.SyntheticSpec()) == dataclasses.asdict(jsyn.SyntheticSpec())


def test_fixation_labels_are_the_jax_ones():
    rng = np.random.default_rng(6)
    steps = np.where(rng.random((80, 1)) < 0.15, rng.normal(0, 30, (80, 2)),
                     rng.normal(0, 1.5, (80, 2)))
    gaze = np.cumsum(steps, axis=0) + 300
    valid = rng.random(80) > 0.1
    for kw in (dict(), dict(valid=valid), dict(dispersion_px=10.0, min_duration=5)):
        got = tfix.detect_fixations_idt(gaze, **kw)
        want = jfix.detect_fixations_idt(gaze, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), kw
        assert tfix.fixation_segments(got) == jfix.fixation_segments(want)
    assert 0 < got.mean() < 1
