"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Tiny shapes (32², narrow widths) and no JAX: the recorder itself, not the
model, is under test. Off, nothing is kept and no profiler event opens;
on, ``run_clip``, a ``StreamServer`` driven by three ``submit``s and a
``flush``, and an SP train step give the same outputs, bit for bit, and
record the span tree and counters the module's docstring names. Under
``torch.profiler`` every recorded span is a ``gaze.*`` event, with the
same nesting; a full buffer counts the spans it drops; ``trace`` writes
the record beside the Chrome trace.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from gaze_tpu_torch.core.config import (
    ATConfig, ImageConfig, LFConfig, PipelineConfig, SPConfig, TrainConfig, TVL1Config)
from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
from gaze_tpu_torch.serve import StreamServer
from gaze_tpu_torch.train.sp import create_sp_state, make_sp_train_step
from gaze_tpu_torch.utils import profiling
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

B, T, SIZE = 2, 3, 32
CFG = PipelineConfig(
    image=ImageConfig(height=SIZE, width=SIZE),
    tvl1=TVL1Config(pyramid_levels=2, warps=1, iters=2),
    sp=SPConfig(stages=((4, 4), (4, 4), (4, 4, 4), (8, 8, 8), (8, 8, 8)),
                fused_channels=8, decoder_channels=(8, 4, 4, 4)),
    at=ATConfig(feature_dim=8, hidden_size=8, roi_size=1),
    lf=LFConfig(channels=(4,)),
    train=TrainConfig(batch_size=B),
)
STEP_TREE = [("step.preprocess", None), ("step.sp", None), ("sp.encode", "step.sp"),
             ("sp.decode", "step.sp"), ("step.attend", None)]


def frames(seed=0, n=T + 1):
    return np.random.default_rng(seed).integers(0, 256, (B, n, SIZE, SIZE, 3), np.uint8)


def pipeline():
    return GazePipeline(CFG, device="cpu", seed=3)


def run_workload(kind):
    """The workload ``kind`` from a fresh, seeded start: its outputs as
    a flat list of tensors or arrays."""
    f = frames()
    if kind == "clip":
        return list(run_clip(pipeline(), f, np.ones((B, T + 1), np.float32)))
    if kind == "serve":
        srv = StreamServer(CFG, pipeline().state_dicts(), B, device="cpu")
        for slot in range(B):
            srv.attach(slot)
        out = [srv.submit(f[:, t]) for t in range(3)] + [srv.flush()]
        return [r["gaze"] for r in out if r is not None]
    pipe = pipeline()
    state = create_sp_state(pipe, seed=5)
    batch = {"prev": f[:, 0], "cur": f[:, 1],
             "gaze": np.full((B, 2), SIZE / 3, np.float32)}
    state, m = make_sp_train_step(pipe)(state, batch)
    return [m["loss"]] + [p.detach() for p in state.params]


def named(rec):
    """(name, parent's name or None, ids) of each recorded span."""
    spans = rec.spans
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None, s.ids) for s in spans]


def check_tree(kind, rec):
    spans, tree = rec.spans, named(rec)
    assert rec.dropped == 0 and all(s.end_ns >= s.start_ns >= 0 for s in spans)
    for s in spans:   # a child lies inside its parent
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    if kind == "clip":
        assert tree[0] == ("clip.upload", None, {})
        assert [(n, p) for n, p, _ in tree[1:]] == STEP_TREE * T
        assert rec.counters == {"pipeline.steps": T}
    elif kind == "serve":
        stage = {s.ids["tick"]: s for s in spans if s.name == "serve.stage"}
        advance = {s.ids["tick"]: s for s in spans if s.name == "serve.advance"}
        assert sorted(stage) == sorted(advance) == [0, 1, 2]
        assert all(stage[k].end_ns <= advance[k].start_ns for k in stage)
        tick = [("serve.advance", None), ("serve.idt", "serve.advance"),
                ("serve.step", "serve.advance")] + [
            (n, p or "serve.step") for n, p in STEP_TREE] + [
            ("serve.revert", "serve.advance"), ("serve.readback", "serve.advance")]
        stage = [("serve.stage", None)]
        assert [(n, p) for n, p, _ in tree] == stage * 2 + tick + stage + tick * 2
        assert rec.counters == {"serve.ticks": 3, "pipeline.steps": 3}
    else:
        assert [(n, p) for n, p, _ in tree] == [
            ("train.upload", None), ("train.forward", None), ("sp.encode", "train.forward"),
            ("sp.decode", "train.forward"), ("train.backward", None), ("train.optimizer", None)]
        assert rec.counters == {"train.steps": 1}


def gaze_events(prof):
    return [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]


@pytest.mark.parametrize("kind", ["clip", "serve", "train"])
def test_recording_changes_no_output_and_records_the_tree(kind):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.span("step.sp") is profiling.span("serve.stage", tick=1)
        off = run_workload(kind)
    assert gaze_events(prof) == [] and profiling._record is None
    with profiling.recording() as rec:
        on = run_workload(kind)
    assert profiling._record is None
    assert len(on) == len(off)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    check_tree(kind, rec)


def test_profiler_events_are_the_record_on_its_clock():
    with profiling.recording() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_workload("serve")
    events = gaze_events(prof)

    def parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(profiling.SPAN_PREFIX):
            p = p.cpu_parent
        return None if p is None else p.name[len(profiling.SPAN_PREFIX):]

    got = sorted((e.time_range.start, e.name[len(profiling.SPAN_PREFIX):], parent(e))
                 for e in events)
    assert [(n, p) for _, n, p in got] == [(n, p) for n, p, _ in named(rec)]


def test_a_full_buffer_counts_what_it_drops_and_trace_writes_the_record(tmp_path):
    with profiling.recording(capacity=3) as rec:
        for i in range(2):
            with profiling.span("outer", tick=i):
                with profiling.span("inner"):
                    profiling.count("n", 2)
    assert [(s.name, s.parent, s.ids) for s in rec.spans] == [
        ("outer", -1, {"tick": 0}), ("inner", 0, {}), ("outer", -1, {"tick": 1})]
    assert rec.dropped == 1 and rec.counters == {"n": 4}
    with profiling.trace(str(tmp_path)):
        with profiling.span("a", tick=7):
            profiling.count("c")
    with open(tmp_path / profiling.SPANS_FILE) as f:
        saved = json.load(f)
    assert saved["counters"] == {"c": 1} and saved["dropped"] == 0
    assert [(s["name"], s["parent"], s["ids"]) for s in saved["spans"]] == [
        ("a", -1, {"tick": 7})]
    with open(tmp_path / profiling.TRACE_FILE) as f:
        assert any(e.get("name") == "gaze.a" for e in json.load(f)["traceEvents"])


def test_threads_record_whole_spans_and_exact_counts():
    n_threads, n = 8, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work(k):
                for i in range(n):
                    with profiling.span("outer", tick=k * n + i):
                        with profiling.span("inner", tick=k):
                            profiling.count("n")

            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = rec.spans
    assert rec.counters == {"n": n_threads * n} and rec.dropped == 0
    assert len(spans) == 2 * n_threads * n
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    inner = [s for s in spans if s.name == "inner"]
    assert all(spans[s.parent].name == "outer" and spans[s.parent].ids["tick"] // n == s.ids["tick"]
               for s in inner)
