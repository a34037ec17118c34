"""The port's AT training stage (``gaze_tpu_torch/train/at.py``) against
``gaze_tpu/train/at.py`` on the CPU.

- The numpy builders (validation split, windows, onset weights, TBPTT
  schedule, weight sequences) are copies: their outputs are equal bit
  for bit, including the single-video and under-6-fixation branches of
  ``split_at_validation``.
- The plain (zero-carry) and TBPTT steps, a two-layer LSTM from the
  same JAX state: losses 1e-5 relative, the carries handed to the next
  window 1e-5 relative and 1e-6 absolute, gradients within 1e-5 of each
  tensor's largest value, and the parameters after each step within
  1e-5 where the JAX gradient clears 1e-3 of its tensor's largest value
  and within 2 lr per step elsewhere (Adam's first step is a sign test).
- The stateful validation MSE 1e-5 relative.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.models.at import LSTMNet as JLSTMNet
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.train import at as jat
from gaze_tpu_torch.train import at as tat
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import (
    LR,
    assert_grads_close,
    bridged,
    jax_state,
    make_configs,
    port_pipeline,
    port_state,
    to_numpy,
)

C = 16          # feature_dim of the tiny case


def videos(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (n, C)).astype(np.float32) for n in lengths]


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("lengths", [(9, 4, 12, 1, 7), (8,), (5,), (14, 3)])
def test_numpy_builders_are_bit_equal(lengths):
    vw = videos(lengths)
    assert_same(tat.split_at_validation(vw), jat.split_at_validation(vw))
    assert_same(tat.split_at_validation(vw, 0.5), jat.split_at_validation(vw, 0.5))
    for seq_len in (3, 8):
        assert_same(tat.build_at_validation_windows(vw, seq_len),
                    jat.build_at_validation_windows(vw, seq_len))
        for lanes in (1, 2, 3):
            assert_same(tat.build_tbptt_schedule(vw, seq_len, lanes),
                        jat.build_tbptt_schedule(vw, seq_len, lanes))
    rng = np.random.default_rng(1)
    fixsac = (rng.uniform(0, 1, 30) > 0.4).astype(np.float32)
    w = rng.uniform(0, 1, (30, C)).astype(np.float32)
    assert_same(tat.fixation_onset_weights(w, fixsac), jat.fixation_onset_weights(w, fixsac))
    for per_fixation in (True, False):
        for seq_len in (2, 4, 16):
            assert_same(tat.build_weight_sequences(w, fixsac, seq_len, per_fixation),
                        jat.build_weight_sequences(w, fixsac, seq_len, per_fixation))
    assert_same(tat.build_tbptt_schedule(videos((1,)), 4, 2), [])


def test_single_video_split_branches():
    one = videos((8,))
    tr, va = tat.split_at_validation(one)
    assert len(tr[0]) == 6 and len(va[0]) == 2
    few = videos((5,))
    tr, va = tat.split_at_validation(few)
    assert tr[0] is few[0] and va[0] is few[0]


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = make_configs(at=dict(num_layers=2))
    jpipe = JGazePipeline(jcfg)
    jst = jax_state(jat.create_at_state, jpipe)
    return jcfg, tcfg, jpipe, jst


def port(case):
    _, tcfg, _, jst = case
    pipe = port_pipeline(tcfg)
    return pipe, port_state(tat.create_at_state, pipe, jst)


def assert_step_params(st, jparams, jgrads, steps):
    """Within 2 lr per step; after one step, with ``jgrads``, within
    1e-5 where the JAX gradient clears the noise."""
    want = bridged(st.module, jparams)
    sd = st.module.state_dict()
    for name in st.param_names:
        got, w = sd[name].numpy(), want[name].numpy()
        if jgrads is not None and steps == 1:
            gw = bridged(st.module, jgrads)[name].numpy()
            clear = np.abs(gw) > 1e-3 * np.abs(gw).max()
            np.testing.assert_allclose(got[clear], w[clear], rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=2 * LR * steps, err_msg=name)


def test_plain_step(case):
    _, _, jpipe, jst = case
    rng = np.random.default_rng(2)
    batch = {"weights": rng.uniform(0, 1, (3, 6, C)).astype(np.float32),
             "mask": np.array([[1] * 6, [1] * 4 + [0] * 2, [1] * 6], np.float32)}

    def jloss(params):
        ws, mask = batch["weights"], batch["mask"]
        pred = jpipe.lstm.apply({"params": params}, ws[:, :-1])
        m = (mask[:, :-1] * mask[:, 1:])[..., None]
        return jnp.sum((pred - ws[:, 1:]) ** 2 * m) / (jnp.sum(m) * C + 1e-8)

    jg = to_numpy(jax.jit(jax.grad(jloss))(jst.params))
    jstep = jat.make_at_train_step(jpipe)
    pipe, st = port(case)
    step = tat.make_at_train_step(pipe)
    js = jst
    for i in range(2):
        js, jm = jstep(js, batch)
        js = to_numpy(js)
        if i == 0:
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            m = (tb["mask"][:, :-1] * tb["mask"][:, 1:])[..., None]
            pred = pipe.lstm(tb["weights"][:, :-1])
            loss = tat._masked_mse(pred, tb["weights"][:, 1:], m)
            assert_grads_close(st, torch.autograd.grad(loss, st.params), jg)
        st, tm = step(st, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert_step_params(st, js.params, jg, i + 1)
    assert not st.module.bias_ih_l0.requires_grad
    assert float(st.module.bias_ih_l0.abs().max()) == 0.0


def test_tbptt_steps_thread_the_carry(case):
    """Three videos in two lanes over windows of 3: the carry threads
    across windows and resets at each lane's next video."""
    _, tcfg, jpipe, jst = case
    schedule = jat.build_tbptt_schedule(videos((7, 5, 4), seed=3), 3, 2)
    assert len(schedule) >= 3 and any(s["reset"].sum() == 1 for s in schedule[1:])
    L, H = tcfg.at.num_layers, tcfg.at.hidden_size
    jstep = jat.make_at_tbptt_step(jpipe)
    pipe, st = port(case)
    step = tat.make_at_tbptt_step(pipe)
    js = jst
    jc = jh = np.zeros((2, L, H), np.float32)
    tc = th = torch.zeros((2, L, H))
    for i, sched in enumerate(schedule):
        js, jm = jstep(js, dict(sched, carry_c=jc, carry_h=jh))
        js = to_numpy(js)
        jc, jh = np.asarray(jm["carry_c"]), np.asarray(jm["carry_h"])
        st, tm = step(st, dict(sched, carry_c=tc, carry_h=th))
        tc, th = tm["carry_c"], tm["carry_h"]
        assert not tc.requires_grad
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(th.numpy(), jh, rtol=1e-5, atol=1e-6)
        assert_step_params(st, js.params, None, i + 1)
    assert st.step == len(schedule)


def test_reset_zeroes_a_lane_and_rollout_equals_steps(case):
    pipe, _ = port(case)
    lstm = pipe.lstm
    L, H = 2, 12
    rng = np.random.default_rng(4)
    ws = torch.from_numpy(rng.uniform(0, 1, (2, 4, C)).astype(np.float32))
    cc = torch.from_numpy(rng.normal(0, 1, (2, L, H)).astype(np.float32))
    ch = torch.from_numpy(rng.normal(0, 1, (2, L, H)).astype(np.float32))
    batch = {"carry_c": cc, "carry_h": ch, "reset": torch.tensor([1.0, 0.0])}
    with torch.no_grad():
        carries = tat._carries(batch, L)
        _, pred = lstm.rollout(carries, ws)
        _, zero = lstm.rollout(lstm.init_carry(2), ws)
        _, kept = lstm.rollout([(cc[:, i], ch[:, i]) for i in range(L)], ws)
        # step by step equals the rollout
        c = [(cc[:, i], ch[:, i]) for i in range(L)]
        for t in range(4):
            c, p = lstm.step(c, ws[:, t])
            assert torch.allclose(p, kept[:, t], rtol=1e-6, atol=1e-7)
    assert torch.equal(pred[0], zero[0]) and torch.equal(pred[1], kept[1])
    assert not torch.equal(pred[0], kept[0])


def test_stateful_and_stateless_eval(case):
    _, _, jpipe, jst = case
    vw = videos((7, 5, 9), seed=5)
    schedule = jat.build_tbptt_schedule(vw, 4, 2)
    want = jat.make_at_stateful_eval(jpipe)(jst.params, schedule)
    pipe, st = port(case)
    got = tat.make_at_stateful_eval(pipe)(st.module, schedule)
    assert got == pytest.approx(want, rel=1e-5)
    assert np.isnan(tat.make_at_stateful_eval(pipe)(st.module, []))
    seqs, mask = jat.build_at_validation_windows(vw, 4)
    want = float(jat.make_at_eval_step(jpipe)(jst.params, seqs, mask))
    got = float(tat.make_at_eval_step(pipe)(st.module, seqs, mask))
    assert got == pytest.approx(want, rel=1e-5)
    # the sequence forward against flax's scanned cells
    j = JLSTMNet(case[0].at).apply({"params": jst.params}, jnp.asarray(seqs))
    with torch.no_grad():
        np.testing.assert_allclose(st.module(torch.from_numpy(seqs)).numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-6)
