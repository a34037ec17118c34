"""Shared cases of the port's training tests: one tiny configuration built
from both packages' dataclasses, JAX train states with randomized biases
and BatchNorm statistics carried into the port, synthetic batches, and
the comparison helpers.

The configuration: 32² frames, a one-level TV-L1 of 1 warp x 3
iterations (the solve's pyramid and warps are the TV-L1 tests' point, not
these; each level and warp is a copy in every compiled JAX step), VGG
stages of 4-16 channels in the 2,2,3,3,3 layout, a 16-wide LSTM of 12
hidden units pooling one conv5 cell, an LF head of two 4-channel convs,
lr 1e-3 and weight decay 1e-2 (large enough that the decay term shows).
"""

import numpy as np

import jax
import torch

from gaze_tpu.core import config as jconfig
from gaze_tpu.data.synthetic import SyntheticSpec as JSpec
from gaze_tpu.data.synthetic import batch_iterator as jbatches
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import module_to_torch_state, train_state_from_jax

LR = 1e-3
SECTIONS = dict(
    image=dict(height=32, width=32, heatmap_sigma=4.0),
    tvl1=dict(pyramid_levels=1, warps=1, iters=3),
    sp=dict(stages=((4, 4), (8, 8), (8, 8, 8), (16, 16, 16), (16, 16, 16)),
            fused_channels=16, decoder_channels=(16, 8, 8, 4)),
    at=dict(feature_dim=16, hidden_size=12, roi_size=1),
    lf=dict(channels=(4, 4)),
    train=dict(batch_size=4, learning_rate=LR, weight_decay=1e-2),
)


def make_configs(**over):
    """(JAX config, port config) of the tiny case; ``over`` replaces
    fields per section, e.g. ``train=dict(grad_accum=2)``."""
    kw = {k: dict(v, **over.get(k, {})) for k, v in SECTIONS.items()}

    def build(mod):
        return mod.PipelineConfig(**{
            name: getattr(mod, cls)(**kw[name]) for name, cls in (
                ("image", "ImageConfig"), ("tvl1", "TVL1Config"), ("sp", "SPConfig"),
                ("at", "ATConfig"), ("lf", "LFConfig"), ("train", "TrainConfig"))})

    return build(jconfig), build(tconfig)


def randomize(tree, seed):
    """Random biases, BN scales and statistics; kernels kept."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out

    return walk(tree)


def jax_state(create, jpipe, seed=0):
    """A JAX stage state (``create(rng, pipeline)``) with randomized
    biases and BatchNorm statistics, its leaves as numpy arrays. The
    initialization and the optimizer's init run as one jit each: run
    eagerly, each parameter shape compiled its own initializer, about a
    hundred XLA programs for one state."""
    st = jax.jit(lambda key: create(key, jpipe))(jax.random.key(seed))
    st = jax.tree.map(np.asarray, st)
    params = randomize(st.params, seed + 1)
    stats = randomize(st.batch_stats, seed + 2) if st.batch_stats else st.batch_stats
    # numpy leaves throughout: a JAX step donates (deletes) its state's arrays
    return to_numpy(st.replace(params=params, batch_stats=stats,
                               opt_state=jax.jit(st.tx.init)(params)))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def port_pipeline(tcfg, dtype=torch.float32):
    return GazePipeline(tcfg, dtype=dtype, device="cpu")


def port_state(create, pipe, jstate):
    """The port's state for the same stage, carrying ``jstate``."""
    st = create(pipe)
    train_state_from_jax(jstate, st)
    return st


def sp_batch(cfg, B=4, seed=0):
    """A synthetic SP batch (numpy) from the JAX package's corpus."""
    spec = JSpec(num_frames=24, height=cfg.image.height, width=cfg.image.width,
                 blob_sigma=3.0, seed=seed)
    return next(jbatches(spec, batch_size=B, num_batches=1, seed=seed))


def bridged(module, tree, batch_stats=None):
    """A JAX params-shaped tree (params, gradients, moments) in the
    module's layout, by trainable-parameter name."""
    return module_to_torch_state(module, {"params": tree, "batch_stats": batch_stats or {}})


def assert_grads_close(state, grads, jgrads, jstats=None, rtol=1e-5):
    """Every gradient within ``rtol`` of its tensor's largest JAX value
    plus 1e-6 of the model's largest gradient: a bias right before
    train-mode BatchNorm has a gradient of exactly 0 in exact arithmetic,
    and both sides compute float32 cancellation noise there (measured
    6e-8 of the largest gradient)."""
    want = bridged(state.module, jgrads, jstats)
    top = max(float(np.abs(want[n].numpy()).max()) for n in state.param_names)
    for name, g in zip(state.param_names, grads):
        w = want[name].numpy()
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= rtol * float(np.abs(w).max()) + 1e-6 * top, (name, err, np.abs(w).max(), top)


def assert_params_close(state, jparams, jstats=None, atol=0.0, rtol=1e-5):
    """Parameters (and BatchNorm statistics) against the bridged JAX
    ones."""
    want = bridged(state.module, jparams, jstats)
    got = state.module.state_dict()
    for name in state.param_names + list(state.batch_stats()):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)
