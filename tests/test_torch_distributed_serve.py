"""The port's sharded serving and evaluation at world size 2 over gloo on
the CPU: ``DistributedStreamServer``, ``StreamServer(mesh=)``,
``rollout_eval_arrays(mesh=)`` and ``rollout_eval_videos(mesh=)``,
against the JAX package (``make_mesh(2)`` of the 8 virtual CPU devices
where its call takes a mesh) and the port's unsharded calls.

One two-process job (``tests/torch_mp_worker.py``) runs every case once
per module, with the narrow 32² configuration of ``test_torch_serve``
and the same weights through the bridge.

Tolerances: gaze equal, sentinels included, and maps within 1e-5 (as
``test_torch_serve``); rollout sums per scored frame within 1e-4
degrees of AAE and 1/(H·W) of AUC, counts equal (as
``test_torch_rollout``); the two ranks' returned results equal bit for
bit.
"""

import numpy as np
import pytest

from gaze_tpu.data.gtea import build_manifest as jbuild_manifest
from gaze_tpu.evaluation import rollout as jrollout
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.parallel.mesh import make_mesh as jmake_mesh
from gaze_tpu.serve import StreamServer as JStreamServer
from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.serve import StreamServer
from tests.test_torch_models import jax_variables, make_configs
from tests.torch_gtea_tree import write_tree
from tests.torch_mp_worker import drive, finish_job, start_job
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

W, S, SIZE, T = 2, 4, 32, 8
MAP_TOL = 1e-5
IDT_PX = 6.0
AAE_BAND = 1e-4                   # degrees per scored frame
AUC_BAND = 1.0 / (SIZE * SIZE)    # per scored frame
MAPS = ("heatmap", "saliency", "attention")
# Per rank, per frame: local-slot calls before that frame's tick. Rank 0
# leaves slot 1 (global 1) unattached and reattaches slot 0 at frame 3;
# rank 1 detaches slot 1 (global 3) at frame 2 and attaches it again,
# alone, at frame 4.
RANK_CALLS = [
    [[("attach", 0)], [], [], [("attach", 0)], [], []],
    [[("attach", 0), ("attach", 1)], [], [("detach", 1)], [], [("attach", 1)], []],
]
RANK_ACTIONS = [[calls + [("tick",)] for calls in rank] for rank in RANK_CALLS]
# StreamServer(mesh=): global slots, the same calls on every rank, with
# an attach and a detach while a submit is pending.
MESHED_ACTIONS = [
    [("attach", 0), ("attach", 1), ("attach", 2), ("tick",)], [("tick",)], [("submit",)],
    [("submit",), ("attach", 3), ("submit",)], [("flush",), ("detach", 1), ("tick",)],
]
VIDEOS = {"Ann_Soup": 7, "Ben_Tea": 5, "Cal_Nap": 1, "Dee_Jam": 4, "Eve_Pie": 3}
HW, GROUP, CHUNK = (24, 32), 3, 3


def union_script(jsrv, frames):
    """The JAX StreamServer over the whole pool, given both ranks' calls
    (rank r's local slot i is global slot r * S/W + i) at each frame."""
    per = S // W
    out = []
    for t in range(len(RANK_CALLS[0])):
        for r in range(W):
            for verb, slot in RANK_CALLS[r][t]:
                getattr(jsrv, verb)(r * per + slot)
        out.append(jsrv.tick(frames[t]))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two ranks' results, and the JAX references, computed here
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("dist_serve")
    jcfg, tcfg = make_configs(image=dict(height=SIZE, width=SIZE),
                              tvl1=dict(pyramid_levels=2, warps=1, iters=3))
    v = jax_variables(jcfg)
    weights = torch_state_from_jax(v)
    seqs = [generate_sequence(SyntheticSpec(num_frames=T + 1, height=SIZE, width=SIZE,
                                            seed=s, blob_sigma=3.0)) for s in range(S)]
    frames = np.stack([s[0] for s in seqs], axis=1)     # (T + 1, S, H, W, 3)
    kw = dict(keep_heatmaps=True, idt_dispersion_px=IDT_PX)

    # rollout_eval_arrays: V=3 (padded to 4 over two ranks), one video
    # with untracked frames
    V = 3
    vids = [generate_sequence(SyntheticSpec(num_frames=T + 1, height=SIZE, width=SIZE,
                                            seed=10 + s, blob_sigma=3.0)) for s in range(V)]
    r_frames, r_gaze, r_fix = (np.stack(x) for x in zip(*vids))
    r_valid = np.ones((V, T + 1), np.float32)
    r_valid[1, 3:5] = 0.0
    r_gaze[1, 3:5] = np.nan

    # rollout_eval_videos: groups of 3 rounded up to 4 over two ranks
    root = write_tree(tmp / "gtea", VIDEOS, HW, seed=11, fixsac=("Ben_Tea",),
                      untracked={"Ann_Soup": (3, 4)},
                      flows={v_: ("packed", "png") for v_ in VIDEOS if VIDEOS[v_] > 1})

    spec = {
        "distributed": {"kind": "distributed_server", "args": dict(
            cfg=tcfg, weights=weights, frames=frames, actions=RANK_ACTIONS)},
        "meshed": {"kind": "meshed_server", "args": dict(
            cfg=tcfg, weights=weights, frames=frames, actions=MESHED_ACTIONS, bad_pool=3)},
        "arrays": {"kind": "rollout_arrays", "args": dict(
            cfg=tcfg, weights=weights, frames=r_frames, gaze=r_gaze, fixsac=r_fix,
            valid=r_valid, chunk_len=4)},
    }
    for flow in (False, True):
        spec[f"videos_{flow}"] = {"kind": "rollout_videos", "args": dict(
            cfg=tcfg, weights=weights, root=root, native_hw=HW, chunk_len=CHUNK,
            group_size=GROUP, flow=flow)}
    ranks = start_job(spec, str(tmp))
    try:
        want_pool = union_script(JStreamServer(jcfg, v, S, **kw), frames)
        unsharded = drive(StreamServer(tcfg, weights, S, device="cpu", **kw), MESHED_ACTIONS,
                          lambda t: frames[t])
        jpipe = JGazePipeline(jcfg)
        jmesh = jmake_mesh(W)
        want_arrays = jrollout.rollout_eval_arrays(jpipe, v, r_frames, r_gaze, r_fix, r_valid,
                                                   chunk_len=4, mesh=jmesh)
        jrecs = jbuild_manifest(root, native_hw=HW).frames
        want_videos = {flow: jrollout.rollout_eval_videos(jpipe, v, jrecs, chunk_len=CHUNK,
                                                          group_size=GROUP, mesh=jmesh,
                                                          use_precomputed_flow=flow)
                       for flow in (False, True)}
    finally:
        ranks = finish_job(ranks)
    return dict(ranks=ranks, want_pool=want_pool, unsharded=unsharded,
                want_arrays=want_arrays, want_videos=want_videos)


def assert_result_close(got, want, what):
    np.testing.assert_array_equal(got["gaze"], want["gaze"], err_msg=what)
    for k in MAPS:
        np.testing.assert_allclose(got[k], want[k], atol=MAP_TOL, rtol=0, err_msg=f"{what} {k}")


def test_distributed_server_matches_jax_on_the_whole_pool(job):
    """Each rank's local results are its block of the JAX server's over
    the concatenated pool, frame by frame, with partial attach, a
    reattach that resets, and one rank attaching while the other does
    not."""
    per = S // W
    for r in range(W):
        got = job["ranks"][r]["distributed"]
        assert got["max_streams"] == S and got["s_local"] == per
        for t, (g, want) in enumerate(zip(got["results"], job["want_pool"])):
            block = {k: want[k][r * per:(r + 1) * per] for k in ("gaze",) + MAPS}
            assert_result_close(g, block, f"rank {r} frame {t}")


def test_distributed_server_sentinels(job):
    """Unattached, first-frame and reattached slots return (-1, -1)."""
    r0 = [x["gaze"] for x in job["ranks"][0]["distributed"]["results"]]
    r1 = [x["gaze"] for x in job["ranks"][1]["distributed"]["results"]]
    assert all((g[1] == -1).all() for g in r0)              # never attached
    assert (r0[0][0] == -1).all() and (r0[1][0] >= 0).all()
    assert (r0[3][0] == -1).all() and (r0[4][0] >= 0).all()  # reattached at frame 3
    assert (r1[2][1] == -1).all() and (r1[3][1] == -1).all()  # detached at frame 2
    assert (r1[4][1] == -1).all() and (r1[5][1] >= 0).all()   # attached alone at 4


def test_distributed_server_submit_lags_tick(job):
    """``submit()`` returns None first and then each previous frame's
    result, equal to ``tick()``'s, on each rank alone."""
    for r in range(W):
        got = job["ranks"][r]["distributed"]
        assert got["submitted"][0] is None
        for t, (a, b) in enumerate(zip(got["ticked"], got["submitted"][1:])):
            np.testing.assert_array_equal(a["gaze"], b["gaze"], err_msg=f"rank {r} {t}")
            for k in MAPS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r} {t} {k}")


def test_meshed_server_matches_the_unsharded_server(job):
    """``StreamServer(mesh=)``: each rank computes its half of the pool
    and both return the whole pool's results, those of the unsharded
    server given the same calls, drains by attach and detach included."""
    want = job["unsharded"]
    for r in range(W):
        got = job["ranks"][r]["meshed"]
        assert got["rows"] == (r * S // W, (r + 1) * S // W)
        assert len(got["results"]) == len(want)
        for i, (g, w) in enumerate(zip(got["results"], want)):
            if w is None:
                assert g is None, i
            else:
                assert_result_close(g, w, f"rank {r} call {i}")


def test_meshed_pool_must_divide_over_the_mesh(job):
    for r in range(W):
        assert "must divide evenly over the 2-rank mesh" in job["ranks"][r]["meshed"]["error"]


@pytest.mark.parametrize("case", ["distributed", "meshed"])
def test_servers_return_equal_results_on_both_ranks(job, case):
    """The meshed server's whole-pool results are bit-equal on both
    ranks; the distributed server's blocks are each rank's own, and its
    tick-versus-submit runs are too."""
    a, b = (job["ranks"][r][case] for r in range(W))
    if case == "meshed":
        for x, y in zip(a["results"], b["results"]):
            if x is not None:
                for k in ("gaze",) + MAPS:
                    np.testing.assert_array_equal(x[k], y[k])
    else:
        assert len(a["results"]) == len(b["results"]) == len(RANK_ACTIONS[0])


def test_rollout_arrays_pads_and_matches_jax(job):
    """V=3 videos padded to 4 with an inactive slot: each rank rolls out
    two, and both return the three videos' sums, those of JAX's
    ``mesh=make_mesh(2)`` call."""
    aae, auc, cnt = job["want_arrays"]
    for r in range(W):
        g_aae, g_auc, g_cnt = job["ranks"][r]["arrays"]
        assert g_cnt.shape == (3,)
        np.testing.assert_array_equal(g_cnt, cnt)
        assert (np.abs(g_aae - aae) <= AAE_BAND * cnt).all(), (g_aae, aae)
        assert (np.abs(g_auc - auc) <= AUC_BAND * cnt).all(), (g_auc, auc)
    for x, y in zip(job["ranks"][0]["arrays"], job["ranks"][1]["arrays"]):
        np.testing.assert_array_equal(x, y)
    assert cnt.tolist() == [T, T - 2, T]


@pytest.mark.parametrize("flow", [False, True])
def test_rollout_videos_matches_jax(job, flow):
    """GTEA videos in groups of 3 rounded up to 4: rank 1 holds the
    shorter videos of the first group (its chunks run on past their end)
    and none of the second; every rank returns every video's result, as
    JAX's ``mesh=make_mesh(2)`` call does."""
    want = job["want_videos"][flow]
    for r in range(W):
        got = job["ranks"][r][f"videos_{flow}"]
        assert set(got) == set(want) == set(VIDEOS)
        for v, (a, u, n) in want.items():
            ga, gu, gn = got[v]
            assert gn == n, v
            if n == 0:   # (0, 0) beside longer videos, as JAX's
                np.testing.assert_equal((ga, gu), (a, u))
            else:
                assert abs(ga - a) <= AAE_BAND and abs(gu - u) <= AUC_BAND, (v, got[v], want[v])
    np.testing.assert_equal(job["ranks"][0][f"videos_{flow}"], job["ranks"][1][f"videos_{flow}"])
