"""The port's SP training stage (``gaze_tpu_torch/train/sp.py``) against
``gaze_tpu/train/sp.py`` on the CPU, from the same JAX state carried
across the weight bridge, on the same synthetic batch.

The flow is solved by both packages' TV-L1 (XLA contracts the JAX
solver's multiply-adds into FMAs, the port rounds each operation), so
the inputs differ by float32 ulps before the network sees them.

Tolerances:
- loss 1e-5 relative; gradients within 1e-4 of each tensor's largest
  value plus 1e-6 of the model's largest (``torch_train_cases``);
- BatchNorm running statistics 1e-5 relative, 1e-6 absolute (1e-4
  after three steps, see ``test_one_and_three_steps``);
- parameters after the step: Adam's first update is a sign test
  (m_hat / (sqrt(v_hat) + eps) is +-1 wherever |g| >> eps), so an
  element whose gradient lies in the comparison noise may move the other
  way: parameters are held within 2 lr per step absolute (plus 1e-5
  relative), and, after one step, within 1e-5 relative where the JAX
  gradient exceeds 1e-3 of its tensor's largest value and 1e-4 of the
  model's (the biases right before BatchNorm have none that does).
- eval AAE within 1e-4 degrees and AUC within 1e-6 of JAX's; extracted
  fixation weights 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.data.augment import apply_hflip as japply_hflip
from gaze_tpu.evaluation.losses import floss as jfloss
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.ops.heatmap import render_gaussian as jrender
from gaze_tpu.train import sp as jsp
from gaze_tpu.train.common import microbatch_value_and_grad as jmicro
from gaze_tpu_torch.data.augment import apply_hflip, with_flip_mask
from gaze_tpu_torch.ops import cuda
from gaze_tpu_torch.train import sp as tsp
from gaze_tpu_torch.train.common import microbatch_value_and_grad
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import (
    LR,
    assert_grads_close,
    assert_params_close,
    bridged,
    jax_state,
    make_configs,
    port_pipeline,
    port_state,
    sp_batch,
    to_numpy,
)

GRAD_RTOL = 1e-4


def jax_grad_fn(jpipe, batch_stats, flip):
    """value_and_grad of the JAX step's loss (gaze_tpu/train/sp.py:57-79)
    with the flip mask taken from the batch."""
    cfg = jpipe.config

    def loss_fn(params, mb):
        if flip:
            mb = japply_hflip(mb, cfg.image.width)
        rgb_in, flow_in = jpipe.preprocess_pair(mb["prev"], mb["cur"], mb.get("flow_img"))
        target = jrender(mb["gaze"], cfg.image.height, cfg.image.width, cfg.image.heatmap_sigma)
        (sal, _), upd = jpipe.sp.apply({"params": params, "batch_stats": batch_stats},
                                       rgb_in, flow_in, train=True, mutable=["batch_stats"])
        return jfloss(sal, target, cfg.loss, sample_weight=mb.get("valid")), upd["batch_stats"]

    return jax.jit(lambda p, b: jmicro(loss_fn, p, b, 1))


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = make_configs()
    jpipe = JGazePipeline(jcfg)
    jst = jax_state(jsp.create_sp_state, jpipe)
    batch = sp_batch(jcfg)
    batch["valid"] = np.array([1, 1, 0, 1], np.float32)
    step = jsp.make_sp_train_step(jpipe)
    states = [jst]
    losses = []
    for _ in range(3):
        s, m = step(states[-1], batch)
        states.append(to_numpy(s))
        losses.append(float(m["loss"]))
    (_, jbs), jg = jax_grad_fn(jpipe, jst.batch_stats, False)(jst.params, batch)
    return dict(jcfg=jcfg, tcfg=tcfg, jpipe=jpipe, jst=jst, batch=batch, states=states,
                losses=losses, grads=to_numpy(jg), stats=to_numpy(jbs))


def port(case, **over):
    tcfg = case["tcfg"]
    if over:
        tcfg = make_configs(**over)[1]
    pipe = port_pipeline(tcfg)
    return pipe, port_state(tsp.create_sp_state, pipe, case["jst"])


def grads_of(pipe, st, batch):
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    rgb_in, flow_in = pipe.preprocess_pair(b["prev"], b["cur"])
    (loss, stats), g = microbatch_value_and_grad(
        lambda mb: tsp.sp_loss(pipe, rgb_in, flow_in, mb), st.params, b, 1)
    return loss, stats, g, flow_in


def assert_first_step_params(st, jst1, jgrads):
    """After one step: within 1e-5 where the JAX gradient clears the
    noise (Adam's sign test), within 2 lr everywhere."""
    want = bridged(st.module, jst1.params, jst1.batch_stats)
    g = bridged(st.module, jgrads, jst1.batch_stats)
    top = max(float(np.abs(g[n].numpy()).max()) for n in st.param_names)
    sd = st.module.state_dict()
    for name in st.param_names:
        got, w, gw = sd[name].numpy(), want[name].numpy(), g[name].numpy()
        clear = np.abs(gw) > max(1e-3 * np.abs(gw).max(), 1e-4 * top)
        np.testing.assert_allclose(got[clear], w[clear], rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=2 * LR, err_msg=name)


def assert_stats_close(st, jst, atol):
    want = bridged(st.module, jst.params, jst.batch_stats)
    for k, v in st.batch_stats().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=atol, err_msg=k)


def test_gradients_and_statistics_of_the_first_step(case):
    pipe, st = port(case)
    loss, stats, g, flow_in = grads_of(pipe, st, case["batch"])
    assert not flow_in.requires_grad and all(p.requires_grad for p in st.params)
    assert float(loss) == pytest.approx(case["losses"][0], rel=1e-5)
    assert_grads_close(st, g, case["grads"], case["jst"].batch_stats, rtol=GRAD_RTOL)
    want = bridged(st.module, case["jst"].params, case["stats"])
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_one_and_three_steps(case):
    pipe, st = port(case)
    step = tsp.make_sp_train_step(pipe)
    cuda.reset_launch_counts()
    losses = []
    for i in range(3):
        st, m = step(st, case["batch"])
        losses.append(float(m["loss"]))
        if i == 0:
            assert_first_step_params(st, case["states"][1], case["grads"])
            assert_stats_close(st, case["states"][1], atol=1e-6)
    np.testing.assert_allclose(losses, case["losses"], rtol=1e-5)
    assert st.step == 3 and st.opt_state.count == 3
    assert_params_close(st, case["states"][3].params, case["states"][3].batch_stats,
                        atol=3 * 2 * LR)
    # the third step's statistics come from parameters that took two sign
    # tests: a bias right before a BatchNorm moves its batch mean by up to
    # 2 lr per step, its running mean by 0.01 of that (measured 2.5e-5)
    assert_stats_close(st, case["states"][3], atol=1e-4)
    # the CPU path takes the plain versions of K1 and K2: nothing launched
    assert all(k.launches == 0 for k in cuda.kernels().values())


def test_grad_accum_two_microbatches(case):
    """grad_accum=2: mean gradient, per-microbatch BatchNorm, the last
    microbatch's statistics. The second microbatch's frames are inverted
    so that the two halves' statistics differ."""
    batch = dict(case["batch"])
    for k in ("prev", "cur"):
        batch[k] = batch[k].copy()
        batch[k][2:] = 255 - batch[k][2:]
    jcfg, _ = make_configs(train=dict(grad_accum=2))
    jpipe = JGazePipeline(jcfg)
    s, m = jsp.make_sp_train_step(jpipe)(case["jst"], batch)
    s = to_numpy(s)
    pipe, st = port(case, train=dict(grad_accum=2))
    st, tm = tsp.make_sp_train_step(pipe)(st, batch)
    assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert_params_close(st, s.params, s.batch_stats, atol=2 * LR)
    assert_stats_close(st, s, atol=1e-6)
    # the last microbatch's update from the initial statistics, bit for
    # bit, and not the whole batch's
    pipe1, st1 = port(case)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        last = pipe1.sp_forward_train(*pipe1.preprocess_pair(b["prev"][2:], b["cur"][2:]))[2]
        whole = pipe1.sp_forward_train(*pipe1.preprocess_pair(b["prev"], b["cur"]))[2]
    for k, v in st.batch_stats().items():
        assert torch.equal(v, last[k]), k
    assert any(not torch.equal(v, whole[k]) for k, v in st.batch_stats().items())


def test_augment_flip_with_an_explicit_mask(case):
    """The same ``_flip`` mask on both sides (JAX's threefry bits are not
    reproduced): loss and gradients of the flipped batch."""
    batch = dict(case["batch"], _flip=np.array([1, 0, 1, 1], np.float32))
    (jl, _), jg = jax_grad_fn(case["jpipe"], case["jst"].batch_stats, True)(
        case["jst"].params, batch)
    pipe, st = port(case, train=dict(augment_flip=True))
    step = tsp.make_sp_train_step(pipe)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    fb = apply_hflip(b, 32)
    rgb_in, flow_in = pipe.preprocess_pair(fb["prev"], fb["cur"])
    (loss, _), g = microbatch_value_and_grad(
        lambda mb: tsp.sp_loss(pipe, rgb_in, flow_in, fb), st.params, b, 1)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(loss) != pytest.approx(case["losses"][0], rel=1e-3)
    assert_grads_close(st, g, to_numpy(jg), case["jst"].batch_stats, rtol=GRAD_RTOL)
    st, m = step(st, batch)
    assert float(m["loss"]) == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("remat", ["encoders", "full"])
def test_remat_gives_the_gradients_of_none(case, remat):
    pipe, st = port(case)
    _, stats0, g0, _ = grads_of(pipe, st, case["batch"])
    pipe2, st2 = port(case, sp=dict(remat=remat))
    _, stats, g, _ = grads_of(pipe2, st2, case["batch"])
    for a, b in zip(g, g0):
        assert torch.equal(a, b)
    for k in stats0:
        assert torch.equal(stats[k], stats0[k])


def test_eval_step_and_fixation_weights(case):
    jpipe, jst, batch = case["jpipe"], case["jst"], case["batch"]
    jm = jsp.make_sp_eval_step(jpipe)(jst, batch)
    pipe, st = port(case)
    m = tsp.make_sp_eval_step(pipe)(st, batch)
    np.testing.assert_allclose(m["aae"].numpy(), np.asarray(jm["aae"]), atol=1e-4)
    np.testing.assert_allclose(m["auc"].numpy(), np.asarray(jm["auc"]), atol=1e-6)
    jw = jsp.extract_fixation_weights(jpipe)(
        {"params": jst.params, "batch_stats": jst.batch_stats}, batch)
    w = tsp.extract_fixation_weights(pipe, st.module.state_dict())(batch)
    assert w.shape == (4, 16)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)


def test_flip_mask_properties():
    """The port's own mask: deterministic in (seed, step), different
    across steps, Bernoulli(0.5); the flip is an involution with the flow
    image's x negated as 255 - v."""
    a = with_flip_mask({"gaze": torch.zeros(64, 2)}, 3, 7)["_flip"]
    assert torch.equal(a, with_flip_mask({"gaze": torch.zeros(64, 2)}, 3, 7)["_flip"])
    b = with_flip_mask({"gaze": torch.zeros(64, 2)}, 3, 8)["_flip"]
    assert not torch.equal(a, b)
    draws = torch.cat([with_flip_mask({"gaze": torch.zeros(100, 2)}, 0, s)["_flip"]
                       for s in range(100)])
    assert set(draws.unique().tolist()) == {0.0, 1.0}
    assert abs(float(draws.mean()) - 0.5) < 4 * 0.5 / np.sqrt(draws.numel())
    rng = np.random.default_rng(0)
    batch = {"prev": torch.from_numpy(rng.integers(0, 256, (4, 6, 8, 3), np.uint8)),
             "cur": torch.from_numpy(rng.integers(0, 256, (4, 6, 8, 3), np.uint8)),
             "flow_img": torch.from_numpy(rng.integers(0, 256, (4, 6, 8, 2), np.uint8)),
             "gaze": torch.from_numpy(rng.integers(0, 8, (4, 2)).astype(np.float32)),
             "_flip": torch.tensor([1.0, 0.0, 1.0, 0.0])}
    once = apply_hflip(batch, 8)
    assert torch.equal(once["flow_img"][0, :, 0, 0], 255 - batch["flow_img"][0, :, -1, 0])
    assert torch.equal(once["flow_img"][0, :, 0, 1], batch["flow_img"][0, :, -1, 1])
    assert torch.equal(once["prev"][1], batch["prev"][1])
    assert float(once["gaze"][0, 0]) == pytest.approx(7 - float(batch["gaze"][0, 0]))
    twice = apply_hflip(once, 8)
    for k in ("prev", "cur", "flow_img", "gaze"):
        assert torch.equal(twice[k], batch[k]), k
    jonce = japply_hflip({k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 8)
    for k in ("prev", "cur", "flow_img", "gaze"):
        np.testing.assert_array_equal(once[k].numpy(), np.asarray(jonce[k]), err_msg=k)


def test_training_mesh_and_kernels_refuse_what_they_cannot_run(case):
    pipe, st = port(case)
    with pytest.raises(TypeError):   # a mesh is a parallel.mesh.Mesh
        tsp.make_sp_train_step(pipe, mesh=object())
    from gaze_tpu_torch.ops.cuda.warp import warp3

    f = [torch.zeros(1, 4, 4) for _ in range(6)]
    f[3] = f[3].requires_grad_()
    with pytest.raises(ValueError):
        warp3(*f)
    assert dataclasses.is_dataclass(case["tcfg"].train)
