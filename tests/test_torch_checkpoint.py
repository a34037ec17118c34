"""The port's checkpoints and training host pieces on the CPU:
``core/checkpoint.py``, ``data/prefetch.py``, ``utils/logging.py``.

- Save and restore are exact; the three newest steps are kept; no
  temporary file is left behind.
- Best tracking: lower is better, a worse or equal metric does not
  overwrite, the metric file sits beside ``<dir>_best`` as in the JAX
  layout, and restore prefers the best to the latest.
- Resume: 2 steps, save, restore into a fresh state, 2 more steps equal
  4 straight steps bit for bit (SP with the flip augmentation on, whose
  mask depends on the step).
- The prefetcher relays a producer's exception; the logger writes the
  JAX package's line format.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from gaze_tpu.utils.logging import StepLogger as JStepLogger
from gaze_tpu_torch.core import checkpoint as ckpt
from gaze_tpu_torch.data.prefetch import device_prefetch
from gaze_tpu_torch.train import sp as tsp
from gaze_tpu_torch.utils.logging import StepLogger
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import make_configs, port_pipeline, sp_batch


def fresh(seed=0, **train):
    _, tcfg = make_configs(train=dict(dict(augment_flip=True), **train))
    pipe = port_pipeline(tcfg)
    return pipe, tsp.create_sp_state(pipe, seed=seed)


def snapshot(st):
    return ({k: v.clone() for k, v in st.module.state_dict().items()},
            [t.clone() for t in st.opt_state.mu + st.opt_state.nu],
            st.opt_state.count, st.step)


def assert_same_state(a, b):
    (sa, ma, ca, pa), (sb, mb, cb, pb) = a, b
    assert sa.keys() == sb.keys() and ca == cb and pa == pb
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for x, y in zip(ma, mb):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def batches():
    _, tcfg = make_configs()
    return [sp_batch(tcfg, seed=s) for s in range(4)]


def test_save_restore_and_keep_three(tmp_path, batches):
    pipe, st = fresh()
    step = tsp.make_sp_train_step(pipe)
    d = str(tmp_path / "sp")
    assert ckpt.latest_step(d) is None
    for i in range(4):
        st, _ = step(st, batches[i])
        ckpt.save_checkpoint(d, st.step, st)
    assert sorted(os.listdir(d)) == ["2.pt", "3.pt", "4.pt"]
    assert ckpt.latest_step(d) == 4
    want = snapshot(st)
    _, other = fresh(seed=1)
    assert ckpt.restore_checkpoint(d, other) is other
    assert_same_state(snapshot(other), want)
    ckpt.restore_checkpoint(d, other, step=2)
    assert other.step == 2
    _, empty = fresh(seed=1)
    before = snapshot(empty)
    ckpt.restore_checkpoint(str(tmp_path / "none"), empty)
    assert_same_state(snapshot(empty), before)


def test_best_tracking(tmp_path, batches):
    pipe, st = fresh()
    step = tsp.make_sp_train_step(pipe)
    d = str(tmp_path / "lf")
    assert ckpt.best_metric(d) is None
    st, _ = step(st, batches[0])
    assert ckpt.save_best_checkpoint(d, st.step, st, 5.0)
    best = snapshot(st)
    st, _ = step(st, batches[1])
    assert not ckpt.save_best_checkpoint(d, st.step, st, 6.0)
    assert not ckpt.save_best_checkpoint(d, st.step, st, 5.0)
    assert ckpt.best_metric(d) == 5.0
    with open(d + "_best.metric.json") as f:
        assert json.load(f) == {"metric": 5.0, "step": 1}
    ckpt.save_checkpoint(d, st.step, st)
    _, other = fresh(seed=2)
    other, restored = ckpt.restore_best_or_latest(d, other, report=True)
    assert restored
    assert_same_state(snapshot(other), best)
    st, _ = step(st, batches[2])
    assert ckpt.save_best_checkpoint(d, st.step, st, 4.5)
    assert ckpt.best_metric(d) == 4.5 and ckpt.latest_step(d + "_best") == 3
    assert not [n for n in os.listdir(tmp_path) + os.listdir(d) if n.endswith(".tmp")]
    _, none = fresh(seed=2)
    assert ckpt.restore_best_or_latest(str(tmp_path / "x"), none, report=True)[1] is False


def test_resume_is_bit_equal(tmp_path, batches):
    pipe, st = fresh()
    step = tsp.make_sp_train_step(pipe)
    for b in batches:
        st, _ = step(st, b)
    straight = snapshot(st)
    pipe, st = fresh()
    step = tsp.make_sp_train_step(pipe)
    for b in batches[:2]:
        st, _ = step(st, b)
    d = str(tmp_path / "sp")
    ckpt.save_checkpoint(d, st.step, st)
    pipe, st = fresh(seed=9)
    step = tsp.make_sp_train_step(pipe)
    ckpt.restore_checkpoint(d, st)
    for b in batches[2:]:
        st, _ = step(st, b)
    assert_same_state(snapshot(st), straight)


def test_prefetch_yields_tensors_and_relays_errors():
    def source():
        yield {"a": np.arange(3), "b": torch.ones(2)}
        raise OSError("corrupt frame")

    it = device_prefetch(source(), "cpu")
    first = next(it)
    assert torch.equal(first["a"], torch.arange(3)) and first["b"].shape == (2,)
    with pytest.raises(OSError, match="corrupt frame"):
        next(it)
    assert [b["x"].item() for b in device_prefetch(({"x": i} for i in range(5)), "cpu")] == \
        list(range(5))


def test_step_logger_lines_match_jax():
    ours, theirs = io.StringIO(), io.StringIO()
    a, b = StepLogger("sp", every=2, stream=ours), JStepLogger("sp", every=2, stream=theirs)
    for s in range(1, 5):
        a.log(s, {"loss": torch.tensor(0.5 * s)})
        b.log(s, {"loss": 0.5 * s})
    a.log(5, {"val_aae": 3.0}, force=True)
    b.log(5, {"val_aae": 3.0}, force=True)
    la = [json.loads(x) for x in ours.getvalue().splitlines()]
    lb = [json.loads(x) for x in theirs.getvalue().splitlines()]
    assert [x["step"] for x in la] == [2, 4, 5]
    for x, y in zip(la, lb):
        assert list(x) == list(y)
        assert {k: v for k, v in x.items() if k != "steps_per_sec"} == \
            {k: v for k, v in y.items() if k != "steps_per_sec"}
