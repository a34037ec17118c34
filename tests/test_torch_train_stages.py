"""The port's trainer (``gaze_tpu_torch/train/stages.py``) end to end on
the CPU: SP -> AT (stateful TBPTT, and stateless) -> LF (teacher-forced,
and rolled out) on the tiny synthetic corpus, 1 epoch of 2 steps each,
into a temporary directory. Every stage writes its checkpoints and its
best, and leaves the best restored in the pipeline; the pipeline then
runs a rollout evaluation. A ``data_root`` raises until the GTEA loader
is ported.
"""

import json
import os

import numpy as np
import pytest
import torch

from gaze_tpu_torch.core.checkpoint import best_metric, latest_step
from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays
from gaze_tpu_torch.train import stages
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import make_configs, port_pipeline


def best_state(directory):
    d = directory + "_best"
    return torch.load(os.path.join(d, f"{latest_step(d)}.pt"), weights_only=True)["module"]


def assert_holds(module, saved):
    sd = module.state_dict()
    assert sd.keys() == saved.keys()
    for k in sd:
        assert torch.equal(sd[k], saved[k]), k


@pytest.mark.parametrize("mode", ["stateful_teacher_forced", "stateless_rollout"])
def test_three_stages_end_to_end(tmp_path, capsys, mode):
    stateless = mode == "stateless_rollout"
    _, tcfg = make_configs()
    pipe = port_pipeline(tcfg)
    opts = stages.StageOptions(batch_size=2, steps_per_epoch=2, save_dir=str(tmp_path),
                               log_every=1, seq_len=4, at_stateless=stateless,
                               lf_rollout=3 if stateless else 0)
    sp = stages.run_train_sp(opts, pipe)
    at = stages.run_train_lstm(opts, pipe, sp)
    lf = stages.run_train_late(opts, pipe, sp, at)
    for name, module in (("sp", pipe.sp), ("at", pipe.lstm), ("lf", pipe.lf)):
        d = str(tmp_path / name)
        assert latest_step(d) is not None and best_metric(d) is not None, name
        assert_holds(module, best_state(d))
    assert lf.module is pipe.lf and lf.step == 2
    assert_holds(pipe.sp, sp)
    assert_holds(pipe.lstm, at)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert {x["stage"] for x in lines} == {"sp", "at", "lf"}
    assert all(np.isfinite(x["loss"]) for x in lines if "loss" in x)
    assert any("val_mse" in x for x in lines) and any("val_auc" in x for x in lines)
    frames, gaze, fixsac = generate_sequence(SyntheticSpec(num_frames=5, height=32, width=32,
                                                           seed=1000))
    sums = rollout_eval_arrays(pipe, frames[None], gaze[None], fixsac[None],
                               np.ones((1, 5), np.float32), chunk_len=4)
    assert sums[2].tolist() == [4.0] and all(np.isfinite(s).all() for s in sums)
    # a second run resumes every stage from its latest checkpoint
    stages.run_train_sp(opts, pipe)
    assert latest_step(str(tmp_path / "sp")) == 4


def test_data_root_waits_for_the_gtea_loader(tmp_path):
    _, tcfg = make_configs()
    pipe = port_pipeline(tcfg)
    opts = stages.StageOptions(batch_size=2, steps_per_epoch=1, save_dir=str(tmp_path),
                               data_root="/data/gteaplus")
    with pytest.raises(NotImplementedError):
        stages.run_train_sp(opts, pipe)
    with pytest.raises(NotImplementedError):
        stages.run_train_lstm(opts, pipe, pipe.sp.state_dict())
    with pytest.raises(NotImplementedError):
        stages.run_train_late(opts, pipe, pipe.sp.state_dict(), pipe.lstm.state_dict())
