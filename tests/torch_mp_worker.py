"""One rank of the port's two-process tests (not collected: no ``test_``
prefix), and :func:`start_job` and :func:`finish_job`, which start the ranks
and collect them.

    python tests/torch_mp_worker.py --rank R --world W --init file:///tmp/x/rdv \
        --spec spec.pkl --out out.R.pkl

The rank joins a gloo process group through the ``init`` URL, makes the
CPU mesh over the whole group and runs the spec's cases in order (every
rank the same cases, as the collectives require). The spec is a pickled
dict ``{case name: {"kind": ..., "args": {...}}}`` written by the test
module; the rank pickles ``{case name: result}``, with tensors as numpy
arrays. torch runs one thread per rank. Imports the port only.
"""

import argparse
import os
import pickle
import subprocess
import sys

import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from gaze_tpu_torch.core.checkpoint import restore_checkpoint  # noqa: E402
from gaze_tpu_torch.core.distributed import global_mesh, initialize  # noqa: E402
from gaze_tpu_torch.data.augment import with_flip_mask  # noqa: E402
from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays, rollout_eval_videos  # noqa: E402
from gaze_tpu_torch.models.pipeline import GazePipeline  # noqa: E402
from gaze_tpu_torch.parallel.mesh import shard_batch  # noqa: E402
from gaze_tpu_torch.serve import DistributedStreamServer, StreamServer  # noqa: E402
from gaze_tpu_torch.train import at, lf, qat, sp, stages  # noqa: E402


def numpy(x):
    """Tensors (in dicts, lists and tuples) as numpy arrays, copied: a
    step updates its state's tensors in place."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, dict):
        return {k: numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(numpy(v) for v in x)
    return x


def snapshot(state):
    """The module's state dict and the optimizer's moments and count."""
    return numpy({"module": state.module.state_dict(), "mu": state.opt_state.mu,
                  "nu": state.opt_state.nu, "count": state.opt_state.count,
                  "step": state.step})


# ------------------------------------------------------------ training ----
STEPS = {
    "sp": (sp.create_sp_state, lambda p, mesh, a: sp.make_sp_train_step(p, mesh)),
    "qat": (sp.create_sp_state, lambda p, mesh, a: qat.make_qat_train_step(p, a["scales"], mesh)),
    "at": (at.create_at_state, lambda p, mesh, a: at.make_at_train_step(p, mesh)),
    "at_tbptt": (at.create_at_state, lambda p, mesh, a: at.make_at_tbptt_step(p, mesh)),
    "lf": (lf.create_lf_state, lambda p, mesh, a: lf.make_lf_train_step(p, a["frozen"], mesh)),
    "lf_rollout": (lf.create_lf_state,
                   lambda p, mesh, a: lf.make_lf_rollout_train_step(p, a["frozen"], mesh)),
}


def train_steps(mesh, step, cfg, state_dir, batches, scales=None, frozen=None):
    """The ``step`` kind's step made for the mesh, from the state saved
    in ``state_dir``, over the global ``batches`` (each rank feeding its
    rows); the state, loss and (TBPTT) carries after each step. The SP
    steps also report their flip coins when the config draws them."""
    create, make = STEPS[step]
    pipe = GazePipeline(cfg, device="cpu")
    state = restore_checkpoint(state_dir, create(pipe))
    fn = make(pipe, mesh, {"scales": scales, "frozen": frozen})
    k = cfg.train.grad_accum if step in ("sp", "qat") else 1
    out = []
    carry = None
    for batch in batches:
        local = shard_batch(mesh, batch, k)
        rec = {}
        if step in ("sp", "qat") and cfg.train.augment_flip:
            rec["flip"] = numpy(with_flip_mask(local, cfg.train.seed, state.step, mesh, k)["_flip"])
        if step == "at_tbptt":
            if carry is None:
                shape = (len(local["mask"]), cfg.at.num_layers, cfg.at.hidden_size)
                carry = (torch.zeros(shape), torch.zeros(shape))
            local["carry_c"], local["carry_h"] = carry
        state, m = fn(state, local)
        if step == "at_tbptt":
            carry = (m["carry_c"], m["carry_h"])
            rec["carry"] = numpy(carry)
        rec.update(loss=float(m["loss"]), state=snapshot(state))
        out.append(rec)
    return out


def sp_eval(mesh, cfg, state_dir, batch):
    """``make_sp_eval_step`` over the mesh on a global batch."""
    pipe = GazePipeline(cfg, device="cpu")
    state = restore_checkpoint(state_dir, sp.create_sp_state(pipe))
    return sp.make_sp_eval_step(pipe, mesh)(state, batch)


def trainer(mesh, cfg, opts):
    """The trainer over the synthetic corpus on the mesh
    ``data_parallel_mesh`` sizes: SP -> QAT -> AT -> LF, then SP again
    into the same directory (a resume). Each stage's state dict, the LF
    state's step, and the files the run left."""
    dp = stages.data_parallel_mesh(opts.batch_size, device="cpu")
    pipe = GazePipeline(cfg, device="cpu")
    sp_sd = stages.run_train_sp(opts, pipe, dp)
    qat_sd = stages.run_train_qat(opts, pipe, sp_sd, dp)
    at_sd = stages.run_train_lstm(opts, pipe, qat_sd, dp)
    lf_st = stages.run_train_late(opts, pipe, qat_sd, at_sd, dp)
    out = numpy({"mesh_size": dp.size, "sp": sp_sd, "qat": qat_sd, "at": at_sd,
                 "lf": lf_st.module.state_dict(), "lf_step": lf_st.step})
    files = sorted(os.path.relpath(os.path.join(d, f), opts.save_dir)
                   for d, _, fs in os.walk(opts.save_dir) for f in fs)
    resumed = stages.run_train_sp(opts, GazePipeline(cfg, device="cpu"), dp)
    out.update(files=files, resumed_sp=numpy(resumed))
    return out


# ------------------------------------------------------------- serving ----
def drive(srv, actions, frames_at):
    """Run ``actions`` on ``srv``: per frame index t a list of
    ("attach"/"detach", slot), ("tick",), ("submit",) or ("flush",), a
    tick or submit taking ``frames_at(t)``. The results in call order."""
    out = []
    for t, calls in enumerate(actions):
        for call in calls:
            if call[0] in ("attach", "detach"):
                getattr(srv, call[0])(call[1])
            elif call[0] == "flush":
                out.append(srv.flush())
            else:
                out.append(getattr(srv, call[0])(frames_at(t)))
    return out


def distributed_server(mesh, cfg, weights, frames, actions):
    """A ``DistributedStreamServer`` of ``frames.shape[1] / size`` slots
    per rank, keeping heatmaps, driven by this rank's ``actions`` (local
    slots, this rank's frames); then two fresh servers, one ticked and
    one fed by ``submit()``, over the first three frames with every slot
    attached."""
    s_local = frames.shape[1] // mesh.size
    mine = slice(mesh.rank * s_local, (mesh.rank + 1) * s_local)

    def server():
        return DistributedStreamServer(cfg, weights, s_local, mesh=mesh, keep_heatmaps=True,
                                       idt_dispersion_px=6.0)

    srv = server()
    out = {"results": drive(srv, actions[mesh.rank], lambda t: frames[t, mine]),
           "max_streams": srv.max_streams, "s_local": srv.s_local}
    everyone = [[("attach", i) for i in range(s_local)]] + [[]] * 2
    out["ticked"] = drive(server(), [a + [("tick",)] for a in everyone],
                          lambda t: frames[t, mine])
    out["submitted"] = drive(server(), [a + [("submit",)] for a in everyone] + [[("flush",)]],
                             lambda t: frames[t, mine])
    return out


def meshed_server(mesh, cfg, weights, frames, actions, bad_pool):
    """``StreamServer(mesh=)`` over the whole pool, every rank handed the
    whole pool's frames, driven by ``actions`` (global slots, the same
    on every rank); and the error of a pool of ``bad_pool`` slots that
    does not divide over the mesh."""
    srv = StreamServer(cfg, weights, frames.shape[1], mesh=mesh, keep_heatmaps=True,
                       idt_dispersion_px=6.0)
    out = drive(srv, actions, lambda t: frames[t])
    try:
        StreamServer(cfg, weights, bad_pool, mesh=mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"results": out, "rows": (srv._rows.start, srv._rows.stop), "error": error}


def rollout_arrays(mesh, cfg, weights, frames, gaze, fixsac, valid, chunk_len):
    pipe = GazePipeline(cfg, device="cpu")
    pipe.load_state_dicts(weights)
    return rollout_eval_arrays(pipe, frames, gaze, fixsac, valid, chunk_len=chunk_len, mesh=mesh)


def rollout_videos(mesh, cfg, weights, root, native_hw, chunk_len, group_size, flow):
    from gaze_tpu_torch.data.gtea import build_manifest

    pipe = GazePipeline(cfg, device="cpu")
    pipe.load_state_dicts(weights)
    recs = build_manifest(root, native_hw=native_hw).frames
    return rollout_eval_videos(pipe, recs, chunk_len=chunk_len, group_size=group_size,
                               use_precomputed_flow=flow, mesh=mesh)


CASES = {"train_steps": train_steps, "sp_eval": sp_eval, "trainer": trainer,
         "distributed_server": distributed_server, "meshed_server": meshed_server,
         "rollout_arrays": rollout_arrays, "rollout_videos": rollout_videos}


def start_job(spec, tmp_path, world: int = 2):
    """Start ``spec`` on ``world`` ranks of this script, rendezvous through
    a file in ``tmp_path``; :func:`finish_job` collects the ranks. The
    caller may compute meanwhile (the ranks run one torch thread each)."""
    spec_path = os.path.join(tmp_path, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    init = "file://" + os.path.join(tmp_path, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world), "--init", init,
         "--spec", spec_path, "--out", os.path.join(tmp_path, f"out.{r}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return procs, tmp_path


def finish_job(job, timeout: float = 300.0):
    """Each rank's results of a :func:`start_job` job. A rank that fails,
    or a job that outlives ``timeout`` seconds (every rank is then
    killed), fails with the ranks' output."""
    procs, tmp_path = job
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    out = []
    for r in range(len(procs)):
        with open(os.path.join(tmp_path, f"out.{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))   # written by the rank started above
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    initialize(args.init, args.world, args.rank, backend="gloo")
    mesh = global_mesh(device="cpu")
    with open(args.spec, "rb") as f:
        spec = pickle.load(f)   # written by the test module that started this rank
    out = {name: numpy(CASES[c["kind"]](mesh, **c["args"])) for name, c in spec.items()}
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
