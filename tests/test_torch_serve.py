"""The port's ``StreamServer`` against the JAX package's on the CPU.

One script of calls runs on both servers (4 slots, 32², narrow widths,
the same weights through the bridge, online I-DT fixations): attach,
tick, submit, an attach while a submit is pending, a detach, flush.
Every result's gaze is equal, sentinels included, and its three maps
are within 1e-5 (float32 in another order; measured 2.3e-6, on the
attention map's min-max normalization). The I-DT labels are equal
after every tick.

The port's ``flush()`` returns a result that a drain by attach() or
detach() kept; the JAX server's drops it. The script pins that
difference at its end.
"""

import warnings

import numpy as np
import pytest

from gaze_tpu.serve import StreamServer as JStreamServer
from gaze_tpu_torch.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.serve import StreamServer
from tests.test_torch_models import jax_variables, make_configs
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

S, SIZE = 4, 32
MAP_TOL = 1e-5
IDT_PX = 6.0


@pytest.fixture(scope="module")
def servers():
    jcfg, tcfg = make_configs(image=dict(height=SIZE, width=SIZE),
                              tvl1=dict(pyramid_levels=2, warps=1, iters=3))
    v = jax_variables(jcfg)
    seqs = [generate_sequence(SyntheticSpec(num_frames=10, height=SIZE, width=SIZE, seed=s,
                                            blob_sigma=3.0))[0] for s in range(S)]
    frames = np.stack(seqs, axis=1)     # (T, S, H, W, 3): one batch per tick

    kw = dict(keep_heatmaps=True, idt_dispersion_px=IDT_PX)
    jsrv = JStreamServer(jcfg, v, S, **kw)
    tsrv = StreamServer(tcfg, torch_state_from_jax(v), S, device="cpu", **kw)
    return jsrv, tsrv, tcfg, v, frames


def script(srv, frames):
    """(label, result) of every call that returns one."""
    out = []
    srv.attach(0)
    srv.attach(1)
    out.append(("tick0", srv.tick(frames[0])))
    out.append(("tick1", srv.tick(frames[1])))
    out.append(("tick2", srv.tick(frames[2])))
    assert srv.submit(frames[3]) is None
    out.append(("submit4->3", srv.submit(frames[4])))
    srv.attach(2)                        # drains frame 4 while it is pending
    out.append(("submit5->4(stash)", srv.submit(frames[5])))
    out.append(("submit6->5", srv.submit(frames[6])))
    srv.detach(1)                        # drains frame 6
    out.append(("submit7->6(stash)", srv.submit(frames[7])))
    out.append(("flush->7", srv.flush()))
    assert srv.flush() is None
    assert srv.submit(frames[8]) is None
    srv.attach(3)                        # drains frame 8: its result is stashed
    out.append(("flush->8(stash)", srv.flush()))
    return out


@pytest.fixture(scope="module")
def scripted(servers):
    jsrv, tsrv, _, _, frames = servers

    def traced(srv):
        """The script, recording the I-DT labels each tick derives."""
        hist = []
        labels = srv._idt_labels

        def recorded():
            hist.append(labels())
            return hist[-1]

        srv._idt_labels = recorded
        try:
            return script(srv, frames), hist
        finally:
            srv._idt_labels = labels

    j, jhist = traced(jsrv)
    t, thist = traced(tsrv)
    labels = [k for k, _ in t]
    return labels, j, t, jhist, thist


def test_scripted_calls_match_jax(scripted):
    labels, j, t, jhist, thist = scripted
    assert [k for k, _ in j] == labels
    for (label, want), (_, got) in zip(j[:-1], t[:-1]):
        np.testing.assert_array_equal(got["gaze"], want["gaze"], err_msg=label)
        for k in ("heatmap", "saliency", "attention"):
            np.testing.assert_allclose(got[k], want[k], atol=MAP_TOL, rtol=0,
                                       err_msg=f"{label} {k}")
    # sentinels: first frames and inactive slots
    first = dict(t)
    assert (first["tick0"]["gaze"] == -1).all()
    assert (first["tick1"]["gaze"][:2] >= 0).all() and (first["tick1"]["gaze"][2:] == -1).all()
    assert (first["submit5->4(stash)"]["gaze"][2] == -1).all()   # slot 2's first frame
    assert (first["flush->7"]["gaze"][1] == -1).all()            # slot 1 detached
    # the I-DT labels fed to every tick are equal, and fixations occurred
    assert len(jhist) == len(thist) == 9
    for a, b in zip(jhist, thist):
        np.testing.assert_array_equal(a, b)
    assert any(h.any() for h in thist)


def test_flush_returns_the_stashed_drain_result(scripted):
    """A drain by attach() keeps frame 8's result: the port's flush()
    returns it; the JAX server's flush() returns None and drops it."""
    labels, j, t, _, _ = scripted
    assert labels[-1] == "flush->8(stash)"
    assert j[-1][1] is None
    got = t[-1][1]
    assert got is not None and got["gaze"].shape == (S, 2)
    assert (got["gaze"][3] == -1).all() and (got["gaze"][0] >= 0).all()


def test_idt_labels_match_jax(servers):
    """Windows with a NaN sample, a wide and a tight dispersion."""
    jsrv, tsrv, *_ = servers
    hist = np.full((S, 3, 2), np.nan, np.float32)
    hist[1] = [[5, 5], [6, 5], [5, 7]]           # dispersion 3: fixation
    hist[2] = [[5, 5], [15, 5], [5, 5]]          # dispersion 10: saccade
    hist[3] = [[5, 5], [np.nan, np.nan], [5, 5]]
    for srv in (jsrv, tsrv):
        srv._gaze_hist = hist.copy()
    np.testing.assert_array_equal(tsrv._idt_labels(), jsrv._idt_labels())
    np.testing.assert_array_equal(tsrv._idt_labels(), [0, 1, 0, 0])


def test_static_mode_and_always_alias(servers):
    """"static" flags every frame a fixation; "always" warns and is
    "static"; both equal a tick with explicit all-ones bits."""
    _, _, tcfg, v, frames = servers
    w = torch_state_from_jax(v)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        alias = StreamServer(tcfg, w, 2, fixation_source="always", device="cpu")
    assert any(issubclass(c.category, DeprecationWarning) for c in caught)
    assert alias.fixation_source == "static"
    static = StreamServer(tcfg, w, 2, fixation_source="static", device="cpu",
                          keep_heatmaps=True)
    explicit = StreamServer(tcfg, w, 2, fixation_source="idt", device="cpu",
                            keep_heatmaps=True)
    for srv in (static, explicit):
        srv.attach(0)
        srv.attach(1)
    for t in range(3):
        a = static.tick(frames[t, :2])
        b = explicit.tick(frames[t, :2], np.ones(2, np.float32))
        np.testing.assert_array_equal(a["gaze"], b["gaze"])
        np.testing.assert_array_equal(a["attention"], b["attention"])
    with pytest.raises(ValueError):
        StreamServer(tcfg, w, 2, fixation_source="eye_tracker", device="cpu")


def test_a_refilled_buffer_matches_jax(servers):
    """A caller that refills one tensor in place every call: each tick
    and each submit() must see the frame the buffer held when it was
    passed, and the next tick's flow must pair it with that frame, as
    the JAX server (whose arrays are immutable) computes it."""
    import torch

    _, _, tcfg, v, frames = servers
    kw = dict(keep_heatmaps=True, idt_dispersion_px=IDT_PX)
    jsrv = JStreamServer(make_configs(image=dict(height=SIZE, width=SIZE),
                                      tvl1=dict(pyramid_levels=2, warps=1, iters=3))[0],
                         v, S, **kw)
    tsrv = StreamServer(tcfg, torch_state_from_jax(v), S, device="cpu", **kw)
    buf = torch.empty(frames.shape[1:], dtype=torch.uint8)
    got, want = [], []
    for srv in (jsrv, tsrv):
        srv.attach(0)
        srv.attach(2)
    for t in range(3):
        buf.copy_(torch.from_numpy(frames[t]))
        got.append(tsrv.tick(buf))
        want.append(jsrv.tick(frames[t]))
    for t in range(3, 6):
        buf.copy_(torch.from_numpy(frames[t]))
        got.append(tsrv.submit(buf))
        want.append(jsrv.submit(frames[t]))
    buf.zero_()
    got.append(tsrv.flush())
    want.append(jsrv.flush())
    assert got[3] is None and want[3] is None
    for t, (a, b) in enumerate(zip(got, want)):
        if b is None:
            continue
        np.testing.assert_array_equal(a["gaze"], b["gaze"], err_msg=str(t))
        for k in ("heatmap", "saliency", "attention"):
            np.testing.assert_allclose(a[k], b[k], atol=MAP_TOL, rtol=0, err_msg=f"{t} {k}")
