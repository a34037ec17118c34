"""The port's data-parallel training at world size 2 over gloo on the CPU,
against the JAX package's steps on a 2-device mesh (``make_mesh(2)`` of
the 8 virtual CPU devices).

One two-process job (``tests/torch_mp_worker.py``) runs every case once
per module: each rank restores the same state (a JAX state carried over
the weight bridge and saved as a port checkpoint), feeds its rows of the
same global batches (``shard_batch``, in the microbatch layout at
``grad_accum`` 2) and steps. The cases are built so that the two ranks'
rows hold different counts of valid frames (SP, QAT, LF: ``valid``) or
of masked steps (AT), where a mean of per-rank means would not be the
global mean.

Tolerances:
- ranks against each other: bit for bit (parameters, BatchNorm
  statistics, optimizer moments, losses, carries, eval metrics);
- against JAX: the bands of the single-card tests
  (``tests/test_torch_train_{sp,at,lf}.py``, ``tests/test_torch_qat.py``):
  losses 1e-5 relative (QAT 1e-4: its codes flip at rounding boundaries,
  see ``test_torch_qat``), parameters within 2 lr per step absolute plus
  1e-5 relative (Adam's first step is a sign test), BatchNorm statistics
  1e-5 relative and 1e-6 absolute after one step, 1e-4 after two, TBPTT
  carries 1e-5 relative and 1e-6 absolute, eval AAE 1e-4 degrees and
  AUC 1e-6;
- against the port at world size 1 on the same global batch (the flip
  coin, the trainer): the same parameter band per step.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gaze_tpu.data.synthetic import SyntheticSpec as JSpec
from gaze_tpu.data.synthetic import clip_iterator as jclips
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.parallel.mesh import make_mesh as jmake_mesh
from gaze_tpu.train import at as jat
from gaze_tpu.train import lf as jlf
from gaze_tpu.train import qat as jqat
from gaze_tpu.train import sp as jsp
from gaze_tpu_torch.core.checkpoint import latest_step, save_checkpoint
from gaze_tpu_torch.core.distributed import (
    all_gather_rows,
    all_reduce_flat_,
    global_mesh,
    host_sharded_array,
    initialize,
    local_batch_rows,
    local_batch_slice,
    local_rows,
)
from gaze_tpu_torch.data.augment import flip_mask
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.parallel.mesh import Mesh, checked, make_mesh, shard_batch
from gaze_tpu_torch.train import at as tat
from gaze_tpu_torch.train import lf as tlf
from gaze_tpu_torch.train import sp as tsp
from gaze_tpu_torch.train import stages
from tests.torch_mp_worker import finish_job, start_job
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

W, STEPS = 2, 2
C = 16   # feature_dim of the tiny case
STEP_CASES = ("sp", "sp_accum", "qat", "at", "at_tbptt", "lf", "lf_rollout")


def np_scales(scales):
    return {s: {k: np.asarray(v) for k, v in d.items()} for s, d in scales.items()}


def at_batches():
    """Two batches of 4 windows; rows 0-1 (rank 0) hold 9 valid pairs,
    rows 2-3 (rank 1) hold 3."""
    rng = np.random.default_rng(2)
    mask = np.array([[1] * 6, [1] * 5 + [0], [1] * 3 + [0] * 3, [1, 1] + [0] * 4], np.float32)
    return [{"weights": rng.uniform(0, 1, (4, 6, C)).astype(np.float32), "mask": mask}
            for _ in range(STEPS)]


def tbptt_videos():
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, (n, C)).astype(np.float32) for n in (7, 5, 4)]


def run_jax(step, state, batches, tbptt=None):
    """JAX steps over ``batches``: (losses, states as numpy, carries)."""
    losses, states, carries = [], [], []
    for b in batches:
        if tbptt is not None:
            b = dict(b, carry_c=tbptt[0], carry_h=tbptt[1])
        state, m = step(state, b)
        state = to_numpy(state)
        losses.append(float(m["loss"]))
        states.append(state)
        if tbptt is not None:
            tbptt = (np.asarray(m["carry_c"]), np.asarray(m["carry_h"]))
            carries.append(tbptt)
    return losses, states, carries


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX references, and the two ranks' results of every case. The
    ranks start as soon as their spec is written; the JAX steps run here
    meanwhile."""
    tmp = tmp_path_factory.mktemp("dist_train")
    jmesh = jmake_mesh(W)
    spec, want, references = {}, {}, {}

    def add(name, kind, tcfg, jstate, create, jstep, batches, **extra):
        pipe = port_pipeline(tcfg)
        d = str(tmp / name)
        save_checkpoint(d, 0, port_state(create, pipe, jstate))
        tb = None
        if kind == "at_tbptt":
            L, H = tcfg.at.num_layers, tcfg.at.hidden_size
            tb = (np.zeros((len(batches[0]["mask"]), L, H), np.float32),) * 2
        references[name] = (jstep, jstate, batches, tb)
        spec[name] = {"kind": "train_steps", "args": dict(
            step=kind, cfg=tcfg, state_dir=d, batches=batches, **extra)}

    # SP, QAT: valid 2 + 1 over the two ranks' rows
    jcfg, tcfg = make_configs()
    jpipe = JGazePipeline(jcfg)
    jst = jax_state(jsp.create_sp_state, jpipe)
    sp_batches = [sp_batch(jcfg, seed=s) for s in range(STEPS)]
    for b in sp_batches:
        b["valid"] = np.array([1, 1, 0, 1], np.float32)
    add("sp", "sp", tcfg, jst, tsp.create_sp_state, jsp.make_sp_train_step(jpipe, jmesh),
        sp_batches)
    acfg, tacfg = make_configs(train=dict(grad_accum=2))
    ajpipe = JGazePipeline(acfg)
    add("sp_accum", "sp", tacfg, jst, tsp.create_sp_state,
        jsp.make_sp_train_step(ajpipe, jmesh), sp_batches)
    calib = sp_batch(jcfg, seed=7)
    scales = np_scales(jqat.calibrate_qat_scales(jpipe, {"params": jst.params},
                                                 [(calib["prev"], calib["cur"])]))
    add("qat", "qat", tcfg, jst, tsp.create_sp_state,
        jqat.make_qat_train_step(jpipe, scales, jmesh), sp_batches,
        scales={s: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                for s, d in scales.items()})

    # AT: two-layer LSTM, masked counts 9 + 3; TBPTT over two lanes
    atj, att = make_configs(at=dict(num_layers=2))
    atjpipe = JGazePipeline(atj)
    jat_st = jax_state(jat.create_at_state, atjpipe)
    add("at", "at", att, jat_st, tat.create_at_state,
        jat.make_at_train_step(atjpipe, jmesh), at_batches())
    schedule = jat.build_tbptt_schedule(tbptt_videos(), 3, 2)
    add("at_tbptt", "at_tbptt", att, jat_st, tat.create_at_state,
        jat.make_at_tbptt_step(atjpipe, jmesh), schedule)

    # LF: frozen SP and AT; valid 1 + 2; rollout clips with one untracked frame
    spj = jax_state(jsp.create_sp_state, jpipe, seed=0)
    atf = jax_state(jat.create_at_state, jpipe, seed=3)
    lfj = jax_state(jlf.create_lf_state, jpipe, seed=5)
    jfrozen = {"sp": {"params": spj.params, "batch_stats": spj.batch_stats},
               "at": {"params": atf.params}}
    fpipe = port_pipeline(tcfg)
    frozen = {"sp": port_state(tsp.create_sp_state, fpipe, spj).module.state_dict(),
              "at": port_state(tat.create_at_state, fpipe, atf).module.state_dict()}
    lf_batches = [sp_batch(jcfg, seed=10 + s) for s in range(STEPS)]
    for b in lf_batches:
        b["valid"] = np.array([1, 0, 1, 1], np.float32)
    add("lf", "lf", tcfg, lfj, tlf.create_lf_state,
        jlf.make_lf_train_step(jpipe, jfrozen, jmesh), lf_batches, frozen=frozen)
    clips = list(jclips(JSpec(num_frames=24, height=32, width=32, blob_sigma=3.0, seed=2),
                        batch_size=2, clip_len=3, num_batches=STEPS, seed=2))
    for c in clips:
        c["valid"][1, 2] = 0.0
    add("lf_rollout", "lf_rollout", tcfg, lfj, tlf.create_lf_state,
        jlf.make_lf_rollout_train_step(jpipe, jfrozen, jmesh), clips, frozen=frozen)

    # the flip coin drawn over the global batch, at grad_accum 2
    fcfg = make_configs(train=dict(augment_flip=True, grad_accum=2))[1]
    save_checkpoint(str(tmp / "flip"), 0, port_state(tsp.create_sp_state,
                                                     port_pipeline(fcfg), jst))
    spec["flip"] = {"kind": "train_steps", "args": dict(
        step="sp", cfg=fcfg, state_dir=str(tmp / "flip"), batches=sp_batches)}

    # the SP eval step over the mesh
    spec["sp_eval"] = {"kind": "sp_eval", "args": dict(
        cfg=tcfg, state_dir=str(tmp / "sp"), batch=sp_batches[0])}

    # the trainer: 1 epoch x 2 steps a stage, three synthetic videos
    opts = stages.StageOptions(batch_size=4, steps_per_epoch=2, synthetic_videos=3,
                               seq_len=4, log_every=100, save_dir=str(tmp / "trainer"))
    spec["trainer"] = {"kind": "trainer", "args": dict(cfg=tcfg, opts=opts)}

    ranks = start_job(spec, str(tmp))
    try:
        for name, args in references.items():
            want[name] = run_jax(*args)
        want["sp_eval"] = to_numpy(jsp.make_sp_eval_step(jpipe, jmesh)(jst, sp_batches[0]))
    finally:
        ranks = finish_job(ranks)
    return dict(ranks=ranks, want=want, tcfg=tcfg, fcfg=fcfg, jst=jst, opts=opts,
                sp_batches=sp_batches, tmp=tmp)


def module_of(case, name):
    """An empty port module of the case's stage, for the weight bridge."""
    tcfg = make_configs(at=dict(num_layers=2))[1] if name.startswith("at") else make_configs()[1]
    pipe = port_pipeline(tcfg)
    return {"at": pipe.lstm, "lf": pipe.lf}.get(name.split("_")[0], pipe.sp)


def assert_state_matches_jax(module, got, jstate, steps):
    want = bridged(module, jstate.params, jstate.batch_stats or None)
    params = [n for n, p in module.named_parameters() if p.requires_grad]
    for n in params:
        np.testing.assert_allclose(got[n], want[n].numpy(), rtol=1e-5, atol=2 * LR * steps,
                                   err_msg=n)
    for n in got:
        if n.endswith((".running_mean", ".running_var")):
            tol = dict(rtol=1e-5, atol=1e-6) if steps == 1 else dict(rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[n], want[n].numpy(), err_msg=n, **tol)


@pytest.mark.parametrize("name", STEP_CASES)
def test_step_matches_jax_on_a_two_device_mesh(job, name):
    """Each of the six train steps (and SP at grad_accum 2, whose rank
    rows follow the JAX microbatch layout) at world size 2 against the
    JAX step on the global batch."""
    got = job["ranks"][0][name]
    losses, states, carries = job["want"][name]
    module = module_of(job, name)
    rtol = 1e-4 if name == "qat" else 1e-5
    for i, (rec, loss, js) in enumerate(zip(got, losses, states)):
        assert rec["loss"] == pytest.approx(loss, rel=rtol), (name, i)
        assert rec["state"]["step"] == i + 1
        assert_state_matches_jax(module, rec["state"]["module"], js, i + 1)
    for i, (cc, ch) in enumerate(carries):   # each rank's lane of the JAX carries
        for r in range(W):
            rows = local_batch_slice(len(cc), Mesh(None, W, r, torch.device("cpu")))
            c, h = job["ranks"][r][name][i]["carry"]
            np.testing.assert_allclose(c, cc[rows], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(h, ch[rows], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", STEP_CASES + ("flip",))
def test_ranks_are_bit_equal(job, name):
    """Parameters, BatchNorm statistics, optimizer moments and losses are
    equal on both ranks after every step."""
    a, b = (job["ranks"][r][name] for r in range(W))
    assert len(a) == len(b) >= STEPS
    for x, y in zip(a, b):
        assert x["loss"] == y["loss"]
        sx, sy = x["state"], y["state"]
        assert sx["count"] == sy["count"] and sx["step"] == sy["step"]
        for k in sx["module"]:
            np.testing.assert_array_equal(sx["module"][k], sy["module"][k], err_msg=k)
        for u, v in zip(sx["mu"] + sx["nu"], sy["mu"] + sy["nu"]):
            np.testing.assert_array_equal(u, v)


def test_unequal_valid_counts_need_global_denominators(job):
    """The SP case's rows hold 2 and 1 valid frames: the JAX loss is
    the global weighted mean, which the mean of the two ranks' own
    weighted means (each half stepped alone) misses by several times the
    1e-5 band (measured 8.6e-5 relative)."""
    b = job["sp_batches"][0]
    halves = []
    for r in range(W):
        pipe = port_pipeline(job["tcfg"])
        st = port_state(tsp.create_sp_state, pipe, job["jst"])
        halves.append(float(tsp.make_sp_train_step(pipe)(
            st, {k: v[2 * r:2 * r + 2] for k, v in b.items()})[1]["loss"]))
    naive = float(np.mean(halves))
    want = job["want"]["sp"][0][0]
    assert abs(naive - want) > 4e-5 * abs(want)
    assert job["ranks"][0]["sp"][0]["loss"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("global_batch,k", [(8, 1), (8, 2), (12, 3), (16, 4)])
def test_rank_rows_follow_the_jax_microbatch_layout(global_batch, k):
    """Rank r holds its 1/W of every global microbatch, and its i-th
    local chunk is its share of global microbatch i."""
    rows = [local_batch_rows(global_batch, k, Mesh(None, W, r, torch.device("cpu")))
            for r in range(W)]
    assert sorted(np.concatenate(rows).tolist()) == list(range(global_batch))
    micro = np.arange(global_batch).reshape(k, -1)
    for r in range(W):
        for i, chunk in enumerate(np.split(rows[r], k)):
            assert np.array_equal(chunk, np.array_split(micro[i], W)[r])
    if k == 1:
        s = local_batch_slice(global_batch, Mesh(None, W, 1, torch.device("cpu")))
        assert rows[1].tolist() == list(range(s.start, s.stop))
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_rows(global_batch + 1, k, Mesh(None, W, 0, torch.device("cpu")))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_local_rows_cut_every_entry_of_a_batch(kind):
    """``local_rows`` (the cut of ``shard_batch``, ``device_prefetch``,
    the eval step and the trainer) gives each entry the rank's
    ``local_batch_rows``, arrays staying arrays and tensors tensors; no
    mesh is the whole batch, and entries of other lengths are refused."""
    wrap = np.asarray if kind == "numpy" else torch.as_tensor
    batch = {"x": wrap(np.arange(8)), "y": wrap(np.arange(16).reshape(8, 2))}
    assert local_rows(batch, None) is batch
    for r in range(W):
        mesh = Mesh(None, W, r, torch.device("cpu"))
        got = local_rows(batch, mesh, 2)
        rows = local_batch_rows(8, 2, mesh)
        assert all(type(got[k]) is type(batch[k]) for k in batch)
        assert np.asarray(got["x"]).tolist() == rows.tolist()
        np.testing.assert_array_equal(np.asarray(got["y"]), np.asarray(batch["y"])[rows])
    with pytest.raises(ValueError, match="different lengths"):
        local_rows({"x": wrap(np.arange(8)), "y": wrap(np.arange(6))},
                   Mesh(None, W, 0, torch.device("cpu")))


def test_flip_coin_is_drawn_over_the_global_batch(job):
    """With ``augment_flip`` each rank's coins are its rows of the one
    global draw (at grad_accum 2: the microbatch layout), and the step
    matches the port's single-process step on the global batch."""
    fcfg = job["fcfg"]
    for step in range(STEPS):
        coin = flip_mask(fcfg.train.seed, step, 4).numpy()
        for r in range(W):
            rows = local_batch_rows(4, 2, Mesh(None, W, r, torch.device("cpu")))
            np.testing.assert_array_equal(job["ranks"][r]["flip"][step]["flip"], coin[rows])
    pipe = port_pipeline(fcfg)
    st = port_state(tsp.create_sp_state, pipe, job["jst"])
    step = tsp.make_sp_train_step(pipe)
    for i, b in enumerate(job["sp_batches"]):
        st, m = step(st, b)
        rec = job["ranks"][0]["flip"][i]
        assert rec["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
        for n, v in st.module.state_dict().items():
            np.testing.assert_allclose(rec["state"]["module"][n], v.numpy(), rtol=1e-5,
                                       atol=2 * LR * (i + 1), err_msg=n)


def test_eval_step_over_the_mesh(job):
    """``make_sp_eval_step(mesh=)`` returns every row's metrics on every
    rank, within the eval bands of JAX's."""
    want = job["want"]["sp_eval"]
    for r in range(W):
        got = job["ranks"][r]["sp_eval"]
        np.testing.assert_allclose(got["aae"], want["aae"], atol=1e-4)
        np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-6)
    np.testing.assert_array_equal(job["ranks"][0]["sp_eval"]["aae"],
                                  job["ranks"][1]["sp_eval"]["aae"])


def trainer_band(got, want, steps, what):
    for k, v in want.items():
        if torch.is_floating_point(v):
            np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5,
                                       atol=2 * LR * steps + 1e-6, err_msg=f"{what}.{k}")


def test_trainer_on_two_ranks(job):
    """SP -> QAT -> AT -> LF on the synthetic corpus at world size 2 (the
    mesh ``data_parallel_mesh`` sizes for batch 4; AT's two lanes over
    two ranks): equal weights on both ranks, within the step band of the
    single-process trainer on the same global batches."""
    a, b = (job["ranks"][r]["trainer"] for r in range(W))
    assert a["mesh_size"] == W and a["lf_step"] == b["lf_step"] == 2
    for stage in ("sp", "qat", "at", "lf"):
        for k in a[stage]:
            np.testing.assert_array_equal(a[stage][k], b[stage][k], err_msg=f"{stage}.{k}")
    opts = dataclasses.replace(job["opts"], save_dir=str(job["tmp"] / "trainer_w1"))
    pipe = GazePipeline(job["tcfg"], device="cpu")
    sp_sd = stages.run_train_sp(opts, pipe)
    qat_sd = stages.run_train_qat(opts, pipe, sp_sd)
    at_sd = stages.run_train_lstm(opts, pipe, qat_sd)
    lf_st = stages.run_train_late(opts, pipe, qat_sd, at_sd)
    trainer_band(a["sp"], sp_sd, 2, "sp")
    trainer_band(a["qat"], qat_sd, 4, "qat")
    trainer_band(a["lf"], lf_st.module.state_dict(), 2, "lf")
    # AT trains on features extracted with the QAT weights: its own
    # steps' band
    trainer_band(a["at"], at_sd, latest_step(os.path.join(opts.save_dir, "at")), "at")


def test_trainer_writes_one_directory_from_rank_zero_and_resumes(job):
    """Rank 0 wrote each stage's checkpoints, best copy and QAT scales
    once (no temporary file left), and a second SP run resumed from its
    latest step on both ranks, with equal weights."""
    a, b = (job["ranks"][r]["trainer"] for r in range(W))
    files = a["files"]
    assert files == b["files"]
    for want in ("sp/2.pt", "sp_best/2.pt", "sp_best.metric.json", "sp_qat/2.pt",
                 "sp_qat/qat_act_scales.npz", "lf/2.pt"):
        assert want in files, (want, files)
    assert not [f for f in files if f.endswith(".tmp")]
    assert any(f.startswith("at/") for f in files)
    for k in a["resumed_sp"]:
        np.testing.assert_array_equal(a["resumed_sp"][k], b["resumed_sp"][k], err_msg=k)
    assert max(int(f[3:-3]) for f in files if f.startswith("sp/")) == 2
    assert latest_step(os.path.join(job["opts"].save_dir, "sp")) == 4   # the resumed run's


def test_a_process_without_a_group_is_a_mesh_of_one():
    """Without a process group (one process, no ``initialize``): the
    size-1 mesh on the asked device, whose collectives are the identity,
    and whose rows are the whole batch; a larger mesh, a foreign mesh
    object and a rank outside its mesh are refused."""
    initialize(num_processes=1)   # a no-op for one process
    mesh = global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device.type) == (1, 0, None, "cpu")
    assert make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError, match="initialized process group"):
        make_mesh(2, device="cpu")
    t = torch.arange(6.0).reshape(3, 2)
    assert all_gather_rows(t, mesh) is t
    assert all(torch.equal(a, b) for a, b in zip(all_reduce_flat_([t, t[0]], mesh), [t, t[0]]))
    assert torch.equal(host_sharded_array(t.numpy(), mesh), t)
    batch = {"x": np.arange(8), "y": np.arange(16).reshape(8, 2)}
    got = shard_batch(mesh, batch, num_microbatches=2)
    assert got["x"].tolist() == list(range(8)) and got["y"].shape == (8, 2)
    with pytest.raises(TypeError):
        checked(object())
    with pytest.raises(ValueError, match="outside"):
        checked(Mesh(None, 2, -1, torch.device("cpu")))
    assert checked(None) is None
