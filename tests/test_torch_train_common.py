"""The port's training scaffolding (``gaze_tpu_torch/train/common.py``)
against ``gaze_tpu/train/common.py`` and optax on the CPU.

Tolerances:
- schedules: 1e-6 relative (both compute in float32; ``cos`` and
  ``pow`` may round one ulp apart);
- AdamW with and without clipping, 5 steps on one gradient sequence:
  1e-6 relative, 1e-9 absolute (optax runs eagerly here, one rounding per
  operation as in the port; the bias corrections' float32 ``pow`` may
  differ by an ulp);
- microbatch accumulation (K=2): gradients within 1e-5 of each tensor's
  largest value plus 1e-6 of the model's largest (``torch_train_cases``),
  losses and BatchNorm statistics 1e-5 relative (float32 sums in another
  order);
- the focal loss's gradient at the clip bounds 1e-6 relative (it halves
  there, as ``jnp.clip``'s does);
- ``train_state_from_jax``: the carried state equal to the bridged JAX
  one bit for bit, and a step continued from it as close as AdamW above.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from gaze_tpu.core.config import TrainConfig as JTrainConfig
from gaze_tpu.evaluation.losses import floss as jfloss
from gaze_tpu.models.lf import LateFusion as JLateFusion
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.ops.heatmap import render_gaussian as jrender
from gaze_tpu.train import common as jcommon
from gaze_tpu.train.lf import create_lf_state as jcreate_lf
from gaze_tpu.train.sp import create_sp_state as jcreate_sp
from gaze_tpu_torch.core.config import TrainConfig
from gaze_tpu_torch.evaluation.losses import floss
from gaze_tpu_torch.models.lf import LateFusion
from gaze_tpu_torch.ops.heatmap import render_gaussian
from gaze_tpu_torch.parallel.mesh import make_mesh
from gaze_tpu_torch.train import common
from gaze_tpu_torch.train.lf import create_lf_state
from gaze_tpu_torch.train.sp import create_sp_state
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import (
    assert_grads_close,
    bridged,
    jax_state,
    make_configs,
    port_pipeline,
    port_state,
)

SCHEDULES = [
    dict(lr_schedule="constant"),
    dict(lr_schedule="constant", warmup_steps=3),
    dict(lr_schedule="cosine", lr_decay_steps=7),
    dict(lr_schedule="cosine", warmup_steps=3, lr_decay_steps=9),
    dict(lr_schedule="cosine", warmup_steps=6, lr_decay_steps=4),
    dict(lr_schedule="step", lr_decay_steps=3, lr_decay_rate=0.5),
    dict(lr_schedule="step", warmup_steps=2, lr_decay_steps=3, lr_decay_rate=0.1),
]


def ids(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", SCHEDULES, ids=ids)
def test_schedules_match_optax(kw):
    kw = dict(kw, learning_rate=3e-3)
    want = jcommon.make_lr_schedule(JTrainConfig(**kw))
    got = common.make_lr_schedule(TrainConfig(**kw))
    for count in range(16):
        w = float(want(jnp.asarray(count, jnp.int32)))
        assert got(count) == pytest.approx(w, rel=1e-6, abs=0), count
    if kw.get("warmup_steps"):
        assert got(0) == 0.0


@pytest.mark.parametrize("name", ["cosine", "step"])
def test_decaying_schedules_need_decay_steps(name):
    with pytest.raises(ValueError):
        common.make_lr_schedule(TrainConfig(lr_schedule=name))
    with pytest.raises(ValueError):
        common.make_lr_schedule(TrainConfig(lr_schedule="linear"))


def test_constant_without_warmup_is_a_plain_float():
    assert common.make_optimizer(TrainConfig(learning_rate=2e-4)).learning_rate == 2e-4
    assert callable(common.make_optimizer(TrainConfig(warmup_steps=2)).learning_rate)


def grad_sequence(shapes, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(0, scale, s)).astype(np.float32) for s in shapes] for _ in range(n)]


@pytest.mark.parametrize("clip", [0.0, 1.5])
@pytest.mark.parametrize("kw", SCHEDULES, ids=ids)
def test_adamw_matches_optax(kw, clip):
    """Five updates of the same gradients; clipping at 1.5 triggers on
    some steps (gradient norms 0.5-3) and not on others."""
    kw = dict(kw, learning_rate=1e-2, weight_decay=0.05, grad_clip_norm=clip)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    rng = np.random.default_rng(1)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    scales = [0.05, 0.3, 0.02, 0.4, 0.1]
    grads = [grad_sequence(shapes, 1, seed=i, scale=scales[i])[0] for i in range(5)]
    tx = jcommon.make_optimizer(JTrainConfig(**kw))
    jp = [jnp.asarray(p) for p in p0]
    jst = tx.init(jp)
    ours = common.make_optimizer(TrainConfig(**kw))
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tst = ours.init(tp)
    for g in grads:
        upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        ours.update(tp, [torch.from_numpy(x) for x in g], tst)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert tst.count == 5


def test_clipping_scales_only_at_or_above_the_norm():
    """optax scales by max_norm / g_norm when g_norm >= max_norm; torch's
    clip_grad_norm_ would divide by g_norm + 1e-6."""
    tx = common.AdamW(1.0, 0.0, clip_norm=2.0)
    for norm, expect in ((1.0, 1.0), (2.0, 1.0), (4.0, 0.5)):
        g = torch.tensor([norm, 0.0])
        p = [torch.zeros(2)]
        st = tx.init(p)
        tx.update(p, [g], st)
        assert float(st.mu[0][0]) == pytest.approx(0.1 * norm * expect, rel=1e-7)


# ------------------------------------------------------- microbatching ----
def lf_case(seed=0):
    jcfg, tcfg = make_configs()
    rng = np.random.default_rng(seed)
    maps = rng.uniform(0, 1, (4, 32, 32, 2)).astype(np.float32)
    gaze = rng.uniform(0, 31, (4, 2)).astype(np.float32)
    valid = np.array([1, 0.25, 0, 1], np.float32)
    return jcfg, tcfg, {"maps": maps, "gaze": gaze, "valid": valid}


def test_microbatch_mean_gradient_without_batchnorm():
    """The LF head (no BatchNorm), K=2 against JAX's scanned accumulation
    (the sample weights differ between the microbatches)."""
    jcfg, tcfg, batch = lf_case()
    jpipe = JGazePipeline(jcfg)
    jst = jax_state(jcreate_lf, jpipe)
    lf = JLateFusion(jcfg.lf)

    def jloss(params, mb):
        pred = lf.apply({"params": params}, mb["maps"])
        t = jrender(mb["gaze"], 32, 32, jcfg.image.heatmap_sigma)
        return jfloss(pred, t, jcfg.loss, sample_weight=mb["valid"]), 0.0

    (jl, _), jg = jax.jit(lambda p, b: jcommon.microbatch_value_and_grad(jloss, p, b, 2))(
        jst.params, batch)
    pipe = port_pipeline(tcfg)
    st = port_state(create_lf_state, pipe, jst)

    def loss(mb):
        t = render_gaussian(mb["gaze"], 32, 32, tcfg.image.heatmap_sigma)
        return floss(st.module(mb["maps"]), t, tcfg.loss, sample_weight=mb["valid"]), 0.0

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (l, _), g = common.microbatch_value_and_grad(loss, st.params, tb, 2)
    assert float(l) == pytest.approx(float(jl), rel=1e-5)
    assert_grads_close(st, g, jg)
    with pytest.raises(ValueError):
        common.microbatch_value_and_grad(loss, st.params, tb, 3)


def test_microbatch_batchnorm_stats_are_the_last_microbatchs():
    """SP on preprocessed inputs, K=2: gradients and the returned
    BatchNorm statistics (the last microbatch's update from the step's
    initial statistics) against JAX; the module's own statistics stay
    untouched until applied."""
    jcfg, tcfg = make_configs()
    jpipe = JGazePipeline(jcfg)
    jst = jax_state(jcreate_sp, jpipe)
    rng = np.random.default_rng(3)
    batch = {"rgb": rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32),
             "flow": rng.normal(0, 1, (4, 32, 32, 2)).astype(np.float32),
             "gaze": rng.uniform(0, 31, (4, 2)).astype(np.float32)}

    def jloss(params, mb):
        (sal, _), upd = jpipe.sp.apply({"params": params, "batch_stats": jst.batch_stats},
                                       mb["rgb"], mb["flow"], train=True,
                                       mutable=["batch_stats"])
        t = jrender(mb["gaze"], 32, 32, jcfg.image.heatmap_sigma)
        return jfloss(sal, t, jcfg.loss), upd["batch_stats"]

    (jl, jbs), jg = jax.jit(lambda p, b: jcommon.microbatch_value_and_grad(jloss, p, b, 2))(
        jst.params, batch)
    pipe = port_pipeline(tcfg)
    st = port_state(create_sp_state, pipe, jst)
    before = {k: v.clone() for k, v in st.batch_stats().items()}

    def loss(mb):
        sal, _, stats = pipe.sp_forward_train(mb["rgb"], mb["flow"])
        t = render_gaussian(mb["gaze"], 32, 32, tcfg.image.heatmap_sigma)
        return floss(sal, t, tcfg.loss), stats

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (l, stats), g = common.microbatch_value_and_grad(loss, st.params, tb, 2)
    assert float(l) == pytest.approx(float(jl), rel=1e-5)
    assert_grads_close(st, g, jg, jst.batch_stats)
    want = bridged(st.module, jst.params, to_np(jbs))
    assert set(stats) == set(before)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
        assert torch.equal(st.batch_stats()[k], before[k])


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_train_state_from_jax_carries_the_whole_state():
    """A JAX SP state two steps in (moments and count non-zero) carried
    into the port: parameters, statistics and moments equal to the
    bridged JAX ones bit for bit; then one more update on both sides from
    the same gradients agrees."""
    jcfg, tcfg = make_configs(train=dict(lr_schedule="cosine", warmup_steps=1,
                                         lr_decay_steps=5))
    jpipe = JGazePipeline(jcfg)
    jst = jax_state(jcreate_sp, jpipe)
    shapes = jax.tree.map(lambda x: x.shape, jst.params)
    rng = np.random.default_rng(5)
    gtree = lambda: jax.tree.map(lambda s: rng.normal(0, 0.1, s).astype(np.float32), shapes,
                                 is_leaf=lambda x: isinstance(x, tuple))  # noqa: E731
    for _ in range(2):
        jst = jst.apply_gradients(gtree())
    jst = to_np(jst)
    pipe = port_pipeline(tcfg)
    st = port_state(create_sp_state, pipe, jst)
    assert st.step == 2 and st.opt_state.count == 2
    want = bridged(st.module, jst.params, jst.batch_stats)
    adam = common_adam(jst.opt_state)
    mu, nu = bridged(st.module, adam.mu, jst.batch_stats), bridged(st.module, adam.nu,
                                                                    jst.batch_stats)
    sd = st.module.state_dict()
    for i, name in enumerate(st.param_names):
        assert torch.equal(sd[name], want[name]), name
        assert torch.equal(st.opt_state.mu[i], mu[name]), name
        assert torch.equal(st.opt_state.nu[i], nu[name]), name
    for name in st.batch_stats():
        assert torch.equal(sd[name], want[name]), name
    g = gtree()
    jst2 = to_np(jst.apply_gradients(g))
    gb = bridged(st.module, g, jst.batch_stats)
    st.apply_gradients([gb[n] for n in st.param_names])
    want = bridged(st.module, jst2.params, jst2.batch_stats)
    for name in st.param_names:
        np.testing.assert_allclose(st.module.state_dict()[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def common_adam(opt_state):
    from gaze_tpu_torch.models.weights import _adam_state

    return _adam_state(opt_state)


def test_dp_mesh_waits_for_the_distributed_slice():
    f = lambda s, b: (s, {})  # noqa: E731
    assert common.jit_dp_step(f) is f
    # the distributed slice is ported: a mesh passes, anything else is refused
    assert common.jit_dp_step(f, make_mesh(device="cpu")) is f
    with pytest.raises(TypeError):
        common.jit_dp_step(f, mesh=object())
    assert dataclasses.is_dataclass(common.AdamWState)


def test_focal_loss_gradient_at_the_clip_bounds():
    """Predictions exactly at eps and 1 - eps (a tie of jnp.clip's min /
    max, which halves the gradient there; torch.clamp would pass all of
    it) and saturated beyond them (no gradient on either side)."""
    eps = np.float32(1e-7)
    pred = np.array([[[eps, np.float32(1 - 1e-7), 0.0, 1.0, 0.3, 0.9]]], np.float32)
    target = np.array([[[0.2, 0.7, 0.1, 0.5, 0.4, 0.6]]], np.float32)
    jg = jax.grad(lambda p: jfloss(p, target))(pred)
    p = torch.from_numpy(pred).requires_grad_()
    floss(p, torch.from_numpy(target)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-6)
    assert float(p.grad[0, 0, 0]) != 0 and float(p.grad[0, 0, 2]) == 0
