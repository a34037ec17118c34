"""The port's ``rollout_eval_videos`` against the JAX package's on the CPU,
over a fake GTEA tree written from numpy seeds: five videos of 7, 5, 1,
4 and 1 frames at 24x32 (the model grid is 32², so gaze is scaled by the
decoded size), in lockstep groups of 2 (the last padded), chunks of 3,
narrow widths, the same weights through the bridge; with TV-L1 on the
frames, and with the tree's flow images (packed and x/y layouts).

Bands, per scored frame, as ``tests/test_torch_rollout.py``: AAE within
1e-4 degrees, AUC within 1/(H·W); counts equal. A video alone in a
group of single-frame videos scores (nan, nan, 0); a single-frame video
beside longer ones scores a count of 0. The port's results do not
depend on ``chunk_len``. The host side (``_decode_group_chunk``) is
equal to the JAX package's bit for bit.
"""

import numpy as np
import pytest
import torch

from gaze_tpu.data.gtea import build_manifest as jbuild_manifest
from gaze_tpu.evaluation import rollout as jrollout
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu_torch.data.gtea import build_manifest
from gaze_tpu_torch.evaluation import rollout
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.utils.profiling import recording
from tests.test_torch_models import jax_variables, make_configs
from tests.torch_gtea_tree import write_tree
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

HW, SIZE = (24, 32), 32
VIDEOS = {"Ann_Soup": 7, "Ben_Tea": 5, "Cal_Nap": 1, "Dee_Jam": 4, "Eve_Pie": 1}
GROUP, CHUNK = 2, 3
AAE_BAND = 1e-4               # degrees per scored frame
AUC_BAND = 1.0 / (SIZE * SIZE)  # per scored frame


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Both packages' pipelines with the same weights, the tree's records
    on both sides, and the JAX results with and without flow images."""
    root = write_tree(tmp_path_factory.mktemp("gtea"), VIDEOS, HW, seed=11,
                      fixsac=("Ben_Tea",), untracked={"Ann_Soup": (3, 4)},
                      flows={"Ann_Soup": ("packed", "png"), "Ben_Tea": ("xy", "png"),
                             "Dee_Jam": ("packed", "png")})
    jcfg, tcfg = make_configs(image=dict(height=SIZE, width=SIZE),
                              tvl1=dict(pyramid_levels=2, warps=1, iters=3))
    v = jax_variables(jcfg)
    pipe = GazePipeline(tcfg, device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(v))
    jpipe = JGazePipeline(jcfg)
    jrecs = jbuild_manifest(root, native_hw=HW).frames
    want = {flow: jrollout.rollout_eval_videos(jpipe, v, jrecs, chunk_len=CHUNK,
                                               group_size=GROUP, use_precomputed_flow=flow)
            for flow in (False, True)}
    return dict(pipe=pipe, recs=build_manifest(root, native_hw=HW).frames, jrecs=jrecs,
                want=want, jpipe=jpipe, v=v)


def assert_results_close(got, want):
    assert got.keys() == want.keys()
    for name, (aae, auc, n) in want.items():
        g_aae, g_auc, g_n = got[name]
        assert g_n == n, name
        if np.isnan(aae):
            assert np.isnan(g_aae) and np.isnan(g_auc) and n == 0, name
            continue
        assert abs(g_aae - aae) <= AAE_BAND and abs(g_auc - auc) <= AUC_BAND, (name, got, want)


@pytest.mark.parametrize("flow", [False, True], ids=["tvl1", "flow_images"])
def test_videos_match_jax(corpus, flow):
    with recording() as rec:
        got = rollout.rollout_eval_videos(corpus["pipe"], corpus["recs"], chunk_len=CHUNK,
                                          group_size=GROUP, use_precomputed_flow=flow)
    assert_results_close(got, corpus["want"][flow])
    # counts: the tracked frames after frame 0; a single-frame video
    # scores nothing, alone (nan) or beside longer ones (0)
    assert {k: r[2] for k, r in got.items()} == {"Ann_Soup": 4, "Ben_Tea": 4, "Cal_Nap": 0,
                                                 "Dee_Jam": 3, "Eve_Pie": 0}
    assert np.isnan(got["Eve_Pie"][0]) and got["Cal_Nap"][0] == 0.0
    # one decode wait per chunk: 2 chunks of the first group, 1 of the second
    waits = [s for s in rec.spans if s.name == "rollout.decode_wait"]
    assert len(waits) == 3 and all(s.end_ns >= s.start_ns for s in waits)
    # the sums do not depend on the chunking
    again = rollout.rollout_eval_videos(corpus["pipe"], corpus["recs"], chunk_len=8,
                                        group_size=GROUP, use_precomputed_flow=flow)
    np.testing.assert_equal(again, got)   # nan == nan here


def test_decode_group_chunk_matches_jax(corpus):
    group = ["Ann_Soup", "Ben_Tea"]
    for s in (1, 4):
        got = rollout._decode_group_chunk(group, corpus["recs"], s, CHUNK, GROUP, *HW,
                                          SIZE, SIZE, True)
        want = jrollout._decode_group_chunk(group, corpus["jrecs"], s, CHUNK, GROUP, *HW,
                                            SIZE, SIZE, True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    # Ben_Tea ends at frame 4: its slots past the end are padding
    assert got[0][1, 1:].eq(0).all() and got[4][1, 1:].eq(128).all() and got[3][1, 1] == 0


def test_empty_records_and_mesh_raise(corpus):
    recs = dict(corpus["recs"], Zed_Nil=[])
    with pytest.raises(ValueError, match="empty record lists"):
        rollout.rollout_eval_videos(corpus["pipe"], recs)
    with pytest.raises(ValueError, match="empty record lists"):
        jrollout.rollout_eval_videos(corpus["jpipe"], corpus["v"], dict(corpus["jrecs"],
                                                                       Zed_Nil=[]))
    with pytest.raises(TypeError):   # a mesh is a parallel.mesh.Mesh
        rollout.rollout_eval_videos(corpus["pipe"], corpus["recs"], mesh=object())


def test_chunk_fn_returns_its_own_prev(corpus):
    """A caller that refills one frames buffer in place for the next
    chunk: the ``prev`` returned by the last chunk still holds that
    chunk's last frame, and the sums are those of fresh tensors."""
    pipe = corpus["pipe"]
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 7, SIZE, SIZE, 3), np.uint8)
    fix = torch.ones((2, 3))
    gaze = torch.from_numpy(rng.uniform(0, SIZE - 1, (2, 3, 2)).astype(np.float32))
    valid = torch.ones((2, 3))
    chunk_fn = rollout.make_rollout_chunk_fn(pipe, score_key="saliency")
    runs = []
    for refill in (False, True):
        state, prev = pipe.init_state(2), torch.from_numpy(frames[:, 0].copy())
        buf = torch.empty((2, 3, SIZE, SIZE, 3), dtype=torch.uint8)
        total = 0
        for s in (1, 4):
            chunk = torch.from_numpy(frames[:, s:s + 3].copy())
            if refill:
                buf.copy_(chunk)
                chunk = buf
            state, prev, sums = chunk_fn(state, prev, chunk, fix, gaze, valid)
            total = total + sums
            buf.zero_()
            assert torch.equal(prev, torch.from_numpy(frames[:, s + 2]))
        runs.append(total)
    assert torch.equal(runs[0], runs[1])
