"""The port's LF training stage (``gaze_tpu_torch/train/lf.py``) against
``gaze_tpu/train/lf.py`` on the CPU: frozen SP and AT from one JAX
state each, the LF head's state carried across the weight bridge.

Tolerances (the frozen maps go through both packages' TV-L1, whose
inputs to the network differ by float32 ulps, see
``test_torch_train_sp``):
- frozen saliency and attention maps 1e-5 absolute;
- losses 1e-5 relative;
- LF parameters after a step within 1e-5 where the JAX gradient clears
  1e-3 of its tensor's largest value, within 2 lr elsewhere (Adam's first
  step is a sign test);
- eval AAE 1e-3 degrees (an argmax may move only at a near tie of the
  map, and then fails) and AUC 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.evaluation.losses import floss as jfloss
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.ops.heatmap import render_gaussian as jrender
from gaze_tpu.data.synthetic import SyntheticSpec as JSpec
from gaze_tpu.data.synthetic import clip_iterator as jclips
from gaze_tpu.train import at as jat
from gaze_tpu.train import lf as jlf
from gaze_tpu.train import sp as jsp
from gaze_tpu_torch.ops import cuda
from gaze_tpu_torch.train import at as tat
from gaze_tpu_torch.train import lf as tlf
from gaze_tpu_torch.train import sp as tsp
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import (
    LR,
    bridged,
    jax_state,
    make_configs,
    port_pipeline,
    port_state,
    sp_batch,
    to_numpy,
)


def setup(residual=False):
    jcfg, tcfg = make_configs(lf=dict(residual=residual))
    jpipe = JGazePipeline(jcfg)
    sp = jax_state(jsp.create_sp_state, jpipe, seed=0)
    at = jax_state(jat.create_at_state, jpipe, seed=3)
    lf = jax_state(jlf.create_lf_state, jpipe, seed=5)
    if residual:  # a trained head: the zero-initialised out_conv made random
        rng = np.random.default_rng(7)
        params = jax.tree.map(lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32),
                              lf.params)
        lf = to_numpy(lf.replace(params=params, opt_state=lf.tx.init(params)))
    jfrozen = {"sp": {"params": sp.params, "batch_stats": sp.batch_stats},
               "at": {"params": at.params}}
    pipe = port_pipeline(tcfg)
    frozen = {"sp": port_state(tsp.create_sp_state, pipe, sp).module.state_dict(),
              "at": port_state(tat.create_at_state, pipe, at).module.state_dict()}
    st = port_state(tlf.create_lf_state, pipe, lf)
    return dict(jcfg=jcfg, jpipe=jpipe, jfrozen=jfrozen, jlf=lf, pipe=pipe,
                frozen=frozen, st=st)


@pytest.fixture(scope="module")
def case():
    c = setup()
    c["batch"] = sp_batch(c["jcfg"])
    c["batch"]["valid"] = np.array([1, 0, 1, 1], np.float32)
    return c


def jgrad(case, sal, amap, gaze, weight):
    cfg, jpipe = case["jcfg"], case["jpipe"]

    def loss(params):
        pred = jpipe.lf.apply({"params": params}, jnp.stack([sal, amap], axis=-1))
        t = jrender(gaze, cfg.image.height, cfg.image.width, cfg.image.heatmap_sigma)
        return jfloss(pred, t, cfg.loss, sample_weight=weight)

    return to_numpy(jax.grad(loss)(case["jlf"].params))


def assert_lf_step(st, jparams, jg):
    want, g = bridged(st.module, jparams), bridged(st.module, jg)
    sd = st.module.state_dict()
    for name in st.param_names:
        got, w, gw = sd[name].numpy(), want[name].numpy(), g[name].numpy()
        clear = np.abs(gw) > 1e-3 * np.abs(gw).max()
        np.testing.assert_allclose(got[clear], w[clear], rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=2 * LR, err_msg=name)


def test_frozen_maps_and_teacher_forced_step(case):
    jmaps = jax.jit(lambda b: jlf._frozen_maps(case["jpipe"], case["jfrozen"], b))(case["batch"])
    js, jm = jlf.make_lf_train_step(case["jpipe"], case["jfrozen"])(case["jlf"], case["batch"])
    js = to_numpy(js)
    jg = jgrad(case, *jmaps, case["batch"]["gaze"], case["batch"]["valid"])
    pipe, st = case["pipe"], case["st"]
    step = tlf.make_lf_train_step(pipe, case["frozen"])
    b = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    sal, amap = tlf._frozen_maps(pipe, b)
    np.testing.assert_allclose(sal.numpy(), np.asarray(jmaps[0]), atol=1e-5)
    np.testing.assert_allclose(amap.numpy(), np.asarray(jmaps[1]), atol=1e-5)
    cuda.reset_launch_counts()
    st, m = step(st, case["batch"])
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert_lf_step(st, js.params, jg)
    assert all(k.launches == 0 for k in cuda.kernels().values())
    out = tlf.make_map_extract_step(pipe, case["frozen"])(case["batch"])
    assert torch.equal(out["saliency"], sal) and torch.equal(out["attention"], amap)


def test_residual_head_step():
    c = setup(residual=True)
    batch = sp_batch(c["jcfg"], seed=1)
    jmaps = jax.jit(lambda b: jlf._frozen_maps(c["jpipe"], c["jfrozen"], b))(batch)
    js, jm = jlf.make_lf_train_step(c["jpipe"], c["jfrozen"])(c["jlf"], batch)
    jg = jgrad(c, *jmaps, batch["gaze"], batch["valid"])
    st, m = tlf.make_lf_train_step(c["pipe"], c["frozen"])(c["st"], batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert_lf_step(st, to_numpy(js).params, jg)


def test_rollout_step():
    """B=2 clips of T=3 steps; the frozen rollout runs without autograd
    and the LF head trains on its maps."""
    c = setup()
    spec = JSpec(num_frames=24, height=32, width=32, blob_sigma=3.0, seed=2)
    batch = next(jclips(spec, batch_size=2, clip_len=3, num_batches=1, seed=2))
    batch["valid"][1, 2] = 0.0
    js, jm = jlf.make_lf_rollout_train_step(c["jpipe"], c["jfrozen"])(c["jlf"], batch)
    st, m = tlf.make_lf_rollout_train_step(c["pipe"], c["frozen"])(c["st"], batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = bridged(st.module, to_numpy(js).params)
    for name in st.param_names:
        np.testing.assert_allclose(st.module.state_dict()[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=2 * LR, err_msg=name)
    assert st.step == 1
    other = tlf.create_lf_state(port_pipeline(make_configs()[1]))
    with pytest.raises(ValueError):
        tlf.make_lf_rollout_train_step(c["pipe"], c["frozen"])(other, batch)


@pytest.mark.parametrize("score_key", tlf.SCORE_KEYS)
def test_eval_step(case, score_key):
    jm = jlf.make_lf_eval_step(case["jpipe"], case["jfrozen"], score_key)(
        case["jlf"], case["batch"])
    pipe = port_pipeline(make_configs()[1])
    st = port_state(tlf.create_lf_state, pipe, case["jlf"])
    m = tlf.make_lf_eval_step(pipe, case["frozen"], score_key)(st, case["batch"])
    np.testing.assert_allclose(m["aae"].numpy(), np.asarray(jm["aae"]), atol=1e-3)
    np.testing.assert_allclose(m["auc"].numpy(), np.asarray(jm["auc"]), atol=1e-6)


def test_unknown_score_key_and_mesh(case):
    with pytest.raises(ValueError):
        tlf.make_lf_eval_step(case["pipe"], case["frozen"], "final")
    with pytest.raises(TypeError):   # a mesh is a parallel.mesh.Mesh
        tlf.make_lf_train_step(case["pipe"], case["frozen"], mesh=object())
