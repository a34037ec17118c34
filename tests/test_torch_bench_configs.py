"""The JAX package's benchmark configurations in the port, on the CPU, at
the tiny size of ``tests/torch_train_cases.py`` (32², a one-level TV-L1 of
1 warp x 3 iterations, narrow VGG stages):

- stream independence under each preset of ``PRESETS``: ``run_clip`` at
  B=4, whose rows 2-3 repeat rows 0-1 (as ``bench.py`` cycles 16 seeds over
  128 streams), gives rows 2-3 equal to rows 0-1 bit for bit, and those
  rows equal a B=2 run of the same streams within ``B2_TOL``;
- the production preset's ``StreamServer`` (bf16, half-grid flow) against
  the JAX package's on the same bridged weights, driven as ``bench.py
  --mode serve`` drives it (every slot attached, ``submit()`` per tick,
  then ``flush()``), with the clip's fixation bits;
- the production SP train step (bf16, half-grid flow, as ``bench.py
  --mode train`` runs it) against the JAX package's on the same bridged
  state and batch: loss, gradient and BatchNorm statistics
  (``tests/test_torch_train_sp.py`` holds the float32 step);
- the SP train step on a batch repeated k times, the first half of the
  copies with the batch's gaze targets (A) and the second half with them
  mirrored (B), gives the mean loss and gradient of the steps on A and on
  B and their BatchNorm statistics, from the same state (targets do not
  feed the network, so train-mode BatchNorm sees the same mean and biased
  variance in all three, and the focal loss is a mean over the rows; a
  step that took only some of the rows would give A's), under parity
  (float32) and production (bf16).

Tolerances, with their reasons:

- ``B2_TOL``: the same rows in a batch of 2 and of 4 are computed by the
  same ops; the CPU's convolutions may block a batch of 4 otherwise than
  one of 2 and sum in another order (float32: within 1e-6 of heatmaps in
  [0, 1]; bf16: one bf16 step, 2^-8, of a value near 1). Gaze equal.
- the server: ``tests/test_torch_turbo.py``'s bf16 clip band, 1e-2 on the
  heatmaps (both sides round activations to bf16 at different places);
  gaze equal, or a near tie on the JAX heatmap.
- the production step against JAX: both round activations to bf16, at
  other places (XLA fuses and rounds a fused op's result once, the port
  rounds each op's), on flows that differ by float32 ulps; the loss
  within ``JAX_BF16_LOSS_RTOL`` relative (measured 4e-5), the model's
  gradient within ``JAX_BF16_GRAD_RTOL`` relative L2 (each weight
  gradient is a sum of bf16 products over every position; measured
  2.8e-2, and each side 2.6e-2 to 3.5e-2 from the float32 step), the
  BatchNorm statistics within ``JAX_BF16_STATS_TOL`` relative plus 1e-3
  absolute (one bf16 step, 2^-8, of a mean of bf16 activations). One
  gradient differs more: the output conv's bias, the sum of the
  logit gradient over B x H x W pixels, which the JAX package reduces in
  bf16 (a bf16 sum stops growing once it is 2^8 times its terms: 0.054
  against float32's 0.180 here) and the port in float32. It is held to
  the port's float32 step within ``JAX_BF16_GRAD_RTOL`` relative, and
  the JAX package's to be more than half off it.
- the repeated float32 batch: each gradient within ``GRAD_RTOL`` of its
  tensor's largest value plus 1e-6 of the model's largest gradient (a
  bias right before train-mode BatchNorm has a gradient of exactly 0 in
  exact arithmetic: float32 noise on both sides; ``assert_grads_close``'s
  rule), float32 summed over k times the rows; the loss and statistics
  within 1e-5 relative. The repeated bf16 batch: the whole model's
  gradient within ``BF16_GRAD_RTOL`` relative L2 of the two steps' mean
  (each weight gradient is rounded to bf16, a relative step of 2^-8,
  after a sum over k times the positions in another order), the loss
  within 1e-3. The step on A alone must lie more than 4 x
  ``BF16_GRAD_RTOL`` from that mean, so that the check has teeth.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.serve import StreamServer as JStreamServer
from gaze_tpu.train import sp as jsp
from gaze_tpu_torch.core.config import PRESETS, preset_config
from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
from gaze_tpu_torch.models.quant import calibrate_pipeline_sp
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.serve import StreamServer
from gaze_tpu_torch.train import sp as tsp
from tests.test_torch_models import jax_variables
from tests.test_torch_train_sp import jax_grad_fn
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import bridged, jax_state, make_configs, port_state, sp_batch

S, T = 2, 3
B2_TOL = {"float32": 1e-6, "bfloat16": 2.0**-8}
SERVE_BAND = 1e-2
NEAR_TIE = 1e-5
GRAD_RTOL = 1e-4
BF16_GRAD_RTOL = 2e-2
JAX_BF16_LOSS_RTOL, JAX_BF16_GRAD_RTOL, JAX_BF16_STATS_TOL = 1e-3, 5e-2, 2.0**-8
OUT_BIAS = "decoder.out_conv.bias"


def clip_inputs(size):
    """S streams of T + 1 frames, synthetic sequences of seeds 0 .. S - 1."""
    seqs = [generate_sequence(SyntheticSpec(num_frames=T + 1, height=size, width=size,
                                            seed=s, blob_sigma=3.0)) for s in range(S)]
    fixsac = np.array([[0, 1, 1, 0], [1, 1, 0, 1]], np.float32)
    return np.stack([q[0] for q in seqs]), fixsac


def preset_pipeline(tcfg, name, frames):
    """The port's pipeline of ``PRESETS[name]`` on the CPU; turbo's int8
    streams calibrated as the benchmark calibrates them (the clip's frame
    pairs, the 99.9th percentile, the bf16 stem)."""
    p = PRESETS[name]
    cfg = preset_config(name, tcfg)
    dtype = getattr(torch, p["dtype"])
    qsp = None
    if p["quant"]:
        pairs = [(frames[:, t], frames[:, t + 1]) for t in range(T)]
        qsp = calibrate_pipeline_sp(GazePipeline(cfg, dtype=dtype, device="cpu"), pairs,
                                    percentile=p["quant_percentile"],
                                    bf16_stem=p["quant_stem"] == "bf16")
    return GazePipeline(cfg, dtype=dtype, device="cpu", quant_sp=qsp)


@pytest.mark.parametrize("name", list(PRESETS))
def test_streams_are_independent_under_each_preset(name):
    _, tcfg = make_configs()
    frames, fixsac = clip_inputs(tcfg.image.height)
    pipe = preset_pipeline(tcfg, name, frames)
    hm4, gz4 = run_clip(pipe, np.concatenate([frames, frames]), np.concatenate([fixsac, fixsac]))
    assert torch.equal(hm4[S:], hm4[:S]) and torch.equal(gz4[S:], gz4[:S])
    hm2, gz2 = run_clip(pipe, frames, fixsac)
    diff = float((hm4[:S] - hm2).abs().max())
    assert diff <= B2_TOL[PRESETS[name]["dtype"]], (name, diff)
    assert torch.equal(gz4[:S], gz2)
    # the streams differ, so row equality has teeth
    assert float((hm2[0] - hm2[1]).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def production_servers():
    """The JAX and the port's production-preset servers (bf16, half-grid
    flow) on the same weights, S slots, the maps kept."""
    jcfg, tcfg = make_configs()
    tcfg = preset_config("production", tcfg)
    jcfg = dataclasses.replace(jcfg, tvl1=dataclasses.replace(
        jcfg.tvl1, flow_scale=tcfg.tvl1.flow_scale))
    v = jax_variables(jcfg)
    jsrv = JStreamServer(jcfg, v, S, dtype=jnp.bfloat16, keep_heatmaps=True)
    tsrv = StreamServer(tcfg, torch_state_from_jax(v), S, dtype=torch.bfloat16, device="cpu",
                        keep_heatmaps=True)
    return jsrv, tsrv, tcfg


def bench_serve(srv, frames, fixsac):
    """Every slot attached, one submit() per frame, then flush(): the
    results of frames 0 .. T."""
    for i in range(S):
        srv.attach(i)
    out = []
    for t in range(T + 1):
        r = srv.submit(frames[:, t], fixsac[:, t])
        assert (r is None) == (t == 0)
        if r is not None:
            out.append(r)
    out.append(srv.flush())
    return out


def test_production_server_matches_jax(production_servers):
    jsrv, tsrv, tcfg = production_servers
    frames, fixsac = clip_inputs(tcfg.image.height)
    want = bench_serve(jsrv, frames, fixsac)
    got = bench_serve(tsrv, frames, fixsac)
    assert len(got) == len(want) == T + 1
    np.testing.assert_array_equal(got[0]["gaze"], -1.0)
    np.testing.assert_array_equal(np.asarray(want[0]["gaze"]), -1.0)
    for t in range(1, T + 1):
        j_hm = np.asarray(want[t]["heatmap"], np.float32)
        diff = float(np.abs(got[t]["heatmap"] - j_hm).max())
        assert diff <= SERVE_BAND, (t, diff)
        tie = max(NEAR_TIE, 2 * diff)
        for b in range(S):
            gx, gy = (int(c) for c in got[t]["gaze"][b])
            assert j_hm[b].max() - j_hm[b, gy, gx] <= tie, (t, b, got[t]["gaze"][b],
                                                             np.asarray(want[t]["gaze"][b]))


def step_record(pipe, st, batch):
    """(loss, the gradient the step applies, the new BatchNorm statistics)
    of one ``make_sp_train_step`` step."""
    grads = []
    apply = st.apply_gradients

    def capturing(g, new_batch_stats=None):
        grads.append([x.detach().clone() for x in g])
        return apply(g, new_batch_stats)

    st.apply_gradients = capturing
    st, m = tsp.make_sp_train_step(pipe)(st, batch)
    return float(m["loss"]), grads[0], {k: v.clone() for k, v in st.batch_stats().items()}


def rel_l2(got, want):
    """The whole model's relative L2 difference of two gradient lists."""
    num = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(got, want))
    return (num / sum(float((b.float() ** 2).sum()) for b in want)) ** 0.5


def mirrored(batch, cfg):
    """``batch`` with its gaze targets mirrored through the frame's centre."""
    far = np.array([cfg.image.width - 1, cfg.image.height - 1], np.float32)
    return dict(batch, gaze=far - batch["gaze"])


@pytest.fixture(scope="module")
def production_step():
    """The JAX package's production SP step (bf16, half-grid flow): its
    loss, new BatchNorm statistics and gradient on the tiny batch from a
    JAX state, with that state, the port's config and the batch."""
    jcfg, tcfg = make_configs()
    tcfg = preset_config("production", tcfg)
    jcfg = dataclasses.replace(jcfg, tvl1=dataclasses.replace(
        jcfg.tvl1, flow_scale=tcfg.tvl1.flow_scale))
    jpipe = JGazePipeline(jcfg, dtype=jnp.bfloat16)
    jst = jax_state(jsp.create_sp_state, jpipe)
    batch = sp_batch(jcfg)
    (loss, stats), grads = jax_grad_fn(jpipe, jst.batch_stats, False)(jst.params, batch)
    return dict(tcfg=tcfg, jst=jst, batch=batch, loss=float(loss),
                stats=jax.tree.map(np.asarray, stats), grads=jax.tree.map(np.asarray, grads))


def test_production_sp_step_matches_jax(production_step):
    c = production_step
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = GazePipeline(c["tcfg"], dtype=dtype, device="cpu")
        st = port_state(tsp.create_sp_state, pipe, c["jst"])
        runs[dtype] = step_record(pipe, st, c["batch"])
    loss, grads, stats = runs[torch.bfloat16]
    assert abs(loss - c["loss"]) <= JAX_BF16_LOSS_RTOL * abs(c["loss"]), (loss, c["loss"])
    want = bridged(st.module, c["grads"], c["jst"].batch_stats)
    names = st.param_names
    out = names.index(OUT_BIAS)
    err = rel_l2([g for i, g in enumerate(grads) if i != out],
                 [want[n] for i, n in enumerate(names) if i != out])
    assert err <= JAX_BF16_GRAD_RTOL, err
    f32 = float(runs[torch.float32][1][out])
    assert abs(float(grads[out]) - f32) <= JAX_BF16_GRAD_RTOL * abs(f32), (grads[out], f32)
    assert abs(float(want[OUT_BIAS]) - f32) > 0.5 * abs(f32), (want[OUT_BIAS], f32)
    want = bridged(st.module, c["jst"].params, c["stats"])
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=JAX_BF16_STATS_TOL,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("name,k", [("parity", 2), ("parity", 4), ("production", 4)])
def test_sp_step_on_a_repeated_batch_matches_the_batch(name, k):
    """The step on the batch repeated k times, half the copies with
    targets A and half with targets B, against the mean of the steps on
    the batch with A and with B, from the same state: parity in float32,
    production in bf16 (half-grid flow), as ``bench.py --mode train`` runs
    it."""
    _, tcfg = make_configs()
    cfg = preset_config(name, tcfg)
    dtype = getattr(torch, PRESETS[name]["dtype"])
    batch_a = sp_batch(tcfg)
    batch_b = mirrored(batch_a, tcfg)
    repeated = {key: np.concatenate([v] * (k // 2) + [batch_b[key]] * (k // 2))
                for key, v in batch_a.items()}
    runs = []
    for batch in (batch_a, batch_b, repeated):
        pipe = GazePipeline(cfg, dtype=dtype, device="cpu")
        st = tsp.create_sp_state(pipe, seed=0)
        runs.append(step_record(pipe, st, batch))
    (loss_a, g_a, s_a), (loss_b, g_b, _), (loss_k, g_k, s_k) = runs
    loss1 = (loss_a + loss_b) / 2
    g1 = [(a + b) / 2 for a, b in zip(g_a, g_b)]
    if dtype == torch.float32:
        assert abs(loss_k - loss1) <= 1e-5 * abs(loss1)
        top = max(float(g.abs().max()) for g in g1)
        for name_, a, b in zip(st.param_names, g_k, g1):
            err = float((a - b).abs().max())
            assert err <= GRAD_RTOL * float(b.abs().max()) + 1e-6 * top, (name_, err)
    else:
        assert abs(loss_k - loss1) <= 1e-3 * abs(loss1)
        assert rel_l2(g_k, g1) <= BF16_GRAD_RTOL, rel_l2(g_k, g1)
    # a step on the A rows alone fails the gradient's band
    assert rel_l2(g_a, g1) > 4 * BF16_GRAD_RTOL, rel_l2(g_a, g1)
    for key, v in s_k.items():
        np.testing.assert_allclose(v.numpy(), s_a[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
