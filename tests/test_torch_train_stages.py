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
import types

import numpy as np
import pytest
import torch

from gaze_tpu import cli as jcli
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.train import sp as jsp
from gaze_tpu_torch.core.checkpoint import best_metric, latest_step
from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays
from gaze_tpu_torch.train import stages
from gaze_tpu_torch.train import sp as tsp
from gaze_tpu_torch.train.at import fixation_onset_weights
from gaze_tpu_torch.train.common import microbatch_value_and_grad
from tests.test_torch_train_sp import GRAD_RTOL, assert_first_step_params, jax_grad_fn
from tests.torch_gtea_tree import write_tree
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import (
    assert_grads_close,
    jax_state,
    make_configs,
    port_pipeline,
    port_state,
    to_numpy,
)


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


# Three subjects; "Cal" is held out. Ann_Soup's fixsac marks every frame
# a fixation and its frame 3 is untracked, so ``fixsac x valid`` splits
# that fixation in two.
TREE = {"Ann_Soup": 7, "Ann_Tea": 6, "Ben_Jam": 7, "Cal_Pie": 6}
UNTRACKED = {"Ann_Soup": (3,), "Ben_Jam": (5,)}


@pytest.fixture(scope="module")
def gtea(tmp_path_factory):
    root = write_tree(tmp_path_factory.mktemp("gtea"), TREE, (24, 32), seed=21,
                      fixsac=("Ann_Soup", "Cal_Pie"), untracked=UNTRACKED,
                      flows={v: ("packed", "png") for v in TREE})
    with open(os.path.join(root, "fixsac", "Ann_Soup.txt"), "w") as f:
        f.write("1\n" * TREE["Ann_Soup"])
    jcfg, tcfg = make_configs()
    jpipe = JGazePipeline(jcfg)
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, jpipe=jpipe,
                jst=jax_state(jsp.create_sp_state, jpipe))


def both_options(g, precomputed_flow, batch_size=4):
    opts = stages.StageOptions(batch_size=batch_size, data_root=g["root"], test_subject="Cal",
                               precomputed_flow=precomputed_flow)
    args = types.SimpleNamespace(data_root=g["root"], test_subject="Cal",
                                 batch_size=batch_size, precomputed_flow=precomputed_flow)
    return opts, args


@pytest.mark.parametrize("precomputed_flow", ["off", "auto"])
def test_data_root_first_sp_step_matches_jax(gtea, precomputed_flow):
    """Replaces the test that pinned ``data_root`` raising."""
    opts, args = both_options(gtea, precomputed_flow)
    for train in (False, True):
        got = list(stages._batches(opts, gtea["tcfg"], train))
        want = list(jcli._batches(args, gtea["jcfg"], train))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert ("flow_img" in g) == (precomputed_flow == "auto")
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    batch = want[0]   # the first training batch
    jst = gtea["jst"]
    (_, _), jg = jax_grad_fn(gtea["jpipe"], jst.batch_stats, False)(jst.params, batch)
    s, m = jsp.make_sp_train_step(gtea["jpipe"])(jst, batch)
    pipe = port_pipeline(gtea["tcfg"])
    st = port_state(tsp.create_sp_state, pipe, jst)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    rgb_in, flow_in = pipe.preprocess_pair(b["prev"], b["cur"], b.get("flow_img"))
    (loss, _), g = microbatch_value_and_grad(
        lambda mb: tsp.sp_loss(pipe, rgb_in, flow_in, mb), st.params, b, 1)
    assert_grads_close(st, g, to_numpy(jg), jst.batch_stats, rtol=GRAD_RTOL)
    st, tm = tsp.make_sp_train_step(pipe)(st, batch)
    assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert float(loss) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert_first_step_params(st, to_numpy(s), to_numpy(jg))


def test_extract_video_weights_matches_jax_and_masks_untracked(gtea):
    opts, args = both_options(gtea, "off", batch_size=3)
    jst = gtea["jst"]
    want = jcli._extract_video_weights(args, gtea["jcfg"], gtea["jpipe"],
                                       {"params": jst.params, "batch_stats": jst.batch_stats})
    pipe = port_pipeline(gtea["tcfg"])
    st = port_state(tsp.create_sp_state, pipe, jst)
    got = stages._extract_video_weights(opts, pipe, st.module.state_dict())
    assert len(got) == len(want) == 3   # Ann_Soup, Ann_Tea, Ben_Jam
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    # Ann_Soup: one fixation over all its pairs, split in two at the
    # untracked frame 3
    train, _ = stages._gtea_split(opts, gtea["tcfg"])
    recs = [r for r in train if r.video == "Ann_Soup"][1:]
    fixsac = np.array([r.fixation for r in recs], np.float32)
    valid = np.array([r.gaze_valid for r in recs], np.float32)

    def onsets(bits):
        return len(fixation_onset_weights(np.zeros((len(bits), 1)), bits))

    assert (onsets(fixsac), onsets(fixsac * valid)) == (1, 2)
    assert len(got[0]) == 2


@pytest.mark.parametrize("lf_rollout", [0, 2])
def test_three_stages_on_a_gtea_tree(gtea, tmp_path, capsys, lf_rollout):
    pipe = port_pipeline(gtea["tcfg"])
    opts = stages.StageOptions(batch_size=2, save_dir=str(tmp_path), log_every=1, seq_len=2,
                               data_root=gtea["root"], test_subject="Cal",
                               lf_rollout=lf_rollout)
    sp = stages.run_train_sp(opts, pipe)
    at = stages.run_train_lstm(opts, pipe, sp)
    lf = stages.run_train_late(opts, pipe, sp, at)
    # SP: 6 + 5 + 6 pairs of the training subjects, 8 batches of 2
    assert latest_step(str(tmp_path / "sp")) == 8 and lf.step > 0
    for name in ("sp", "at", "lf"):
        assert best_metric(str(tmp_path / name)) is not None, name
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert all(np.isfinite(x["loss"]) for x in lines if "loss" in x)
