"""``program_spans.py`` on hand-built traces: device ops go to the
innermost program span open at their launch, with and without the
span's children; the server's queue wait pairs spans by their ``tick``;
``tracing.DeviceTrace`` given the program's spans beside the
benchmark's names an idle gap by the innermost of either; every reader
raises where the spans disagree with the program's counters."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark import program_spans as ps
from benchmark.tracing import DeviceTrace, merge

# step.preprocess [0, 1], step.sp [1, 3] over sp.encode [1, 2] and
# sp.decode [2, 3], step.attend [3, 4]
STEP = [("step.preprocess", 0.0, 1.0, {}), ("step.sp", 1.0, 3.0, {}),
        ("sp.encode", 1.0, 2.0, {}), ("sp.decode", 2.0, 3.0, {}),
        ("step.attend", 3.0, 4.0, {})]


def op(launch, seconds, name="k"):
    """(name, device start, end, host launch time): device ops run late."""
    return (name, launch + 10.0, launch + 10.0 + seconds, launch)


def clip_trace(steps=1, counters=None):
    spans = [(n, s + 4 * k, e + 4 * k, i) for k in range(steps) for n, s, e, i in STEP]
    ops = []
    for k in range(steps):
        t = 4 * k
        ops += [op(t + 0.5, 0.1), op(t + 1.0, 0.2), op(t + 1.5, 0.3), op(t + 2.5, 0.4),
                op(t + 2.999, 0.05), op(t + 3.5, 0.5)]
    ops.append(op(-1.0, 0.7))   # launched before any span
    if counters is None:
        counters = {"pipeline.steps": steps}
    return ps.ProgramTrace(spans, ops, counters=counters)


def test_ops_go_to_the_innermost_span_at_their_launch():
    pt = clip_trace()
    assert [pt.count(n) for n, *_ in STEP] == [1] * 5
    got = {n: round(pt.device_s(n), 9) for n, *_ in STEP}
    assert got == {"step.preprocess": 0.1, "step.sp": 0.95, "sp.encode": 0.5,
                   "sp.decode": 0.45, "step.attend": 0.5}
    assert pt.device_s("step.sp", children=False) == 0.0
    assert round(pt.device_s("sp.decode", children=False), 9) == 0.45
    assert pt.parents == [-1, -1, 1, 1, -1]
    info = {"steps": 1}
    assert {k: round(ps.stage_ms(pt, info, n), 6) for k, n in ps.CLIP_STAGES.items()} == {
        "flow_ms": 100.0, "encode_ms": 500.0, "decode_ms": 450.0, "attend_ms": 500.0}


def test_queue_wait_pairs_stage_and_advance_by_tick():
    spans = [("serve.stage", 0.0, 1.0, {"tick": 7}), ("serve.stage", 10.0, 11.0, {"tick": 8}),
             ("serve.advance", 11.5, 15.0, {"tick": 7}),
             ("serve.readback", 13.0, 15.0, {}),
             ("serve.stage", 20.0, 21.0, {"tick": 9}),
             ("serve.advance", 21.5, 25.0, {"tick": 8}),
             ("serve.readback", 24.0, 25.0, {}),
             ("serve.advance", 26.0, 30.0, {"tick": 9}),
             ("serve.readback", 29.0, 30.0, {})]
    pt = ps.ProgramTrace(spans, [], counters={"serve.ticks": 3})
    assert pt.gaps_s("serve.stage", "serve.advance") == [10.5, 10.5, 5.0]
    info = {"units": 3}
    assert ps.queue_ms(pt, info) == pytest.approx(1e3 * np.percentile([10.5, 10.5, 5.0], 95))
    assert ps.serve_host_ms(pt, info, "serve.stage") == pytest.approx(1e3)
    assert ps.serve_host_ms(pt, info, "serve.readback") == pytest.approx(4e3 / 3)
    unpaired = [("serve.advance", s, e, {"tick": 4}) if i.get("tick") == 9 and n != "serve.stage"
                else (n, s, e, i) for n, s, e, i in spans]
    with pytest.raises(RuntimeError, match="2 stage/advance pairs in 3 ticks"):
        ps.queue_ms(ps.ProgramTrace(unpaired, [], counters={"serve.ticks": 3}), info)


@pytest.mark.parametrize("case", ["clip_counter", "clip_kind", "train", "serve"])
def test_every_reader_raises_on_a_count_that_disagrees(case):
    if case == "clip_counter":
        with pytest.raises(RuntimeError, match="pipeline.steps"):
            ps.stage_ms(clip_trace(2, {"pipeline.steps": 3}), {"steps": 2}, "sp.encode")
    elif case == "clip_kind":
        with pytest.raises(RuntimeError, match="the kind's 4"):
            ps.stage_ms(clip_trace(2), {"steps": 4}, "sp.encode")
    elif case == "train":
        spans = [("train.forward", 0.0, 1.0, {}), ("train.backward", 1.0, 2.0, {}),
                 ("train.optimizer", 2.0, 3.0, {}), ("train.optimizer", 3.0, 4.0, {})]
        pt = ps.ProgramTrace(spans, [op(0.5, 0.1)], counters={"train.steps": 2})
        with pytest.raises(RuntimeError, match="spans train.forward in 2 train steps"):
            ps.train_ms(pt, {"steps": 2}, "train.forward")
        assert ps.train_ms(pt, {"steps": 2}, "train.optimizer") == 0.0
    else:
        pt = ps.ProgramTrace([("serve.advance", 0.0, 1.0, {"tick": 0})], [],
                             counters={"serve.ticks": 2})
        with pytest.raises(RuntimeError, match="serve.ticks"):
            ps.serve_host_ms(pt, {"units": 2}, "serve.stage")


def test_idle_gaps_take_the_innermost_span_of_either():
    spans = [("serve.advance", 0.0, 10.0, {}), ("serve.readback", 5.0, 10.0, {})]
    ops = [("k", 1.0, 2.0, 0.5), ("k", 9.0, 9.5, 4.0), ("k", 20.0, 21.0, 11.0)]
    bench = [("submit", 0.0, 10.0), ("wait_due", 10.0, 19.5)]
    pt = ps.ProgramTrace(spans, ops)
    assert [i for *_, i in pt.ops] == [0, 0, -1]
    # what PERF.md's edit of device_trace hands idle_gaps: both kinds of span
    named = bench + [(n, s, e) for n, s, e, _ in pt.spans]
    trace = DeviceTrace({"k": (2.5, 3)}, merge([(s, e) for _, s, e, _ in pt.ops]), named, 21.0)
    assert trace.idle_gaps() == [["wait_due", 10.5], ["serve.readback", 7.0],
                                 ["serve.advance", 1.0]]
    # the benchmark's spans alone name the same gaps as before
    assert DeviceTrace({}, trace.intervals, bench, 21.0).idle_gaps() == [
        ["wait_due", 10.5], ["submit", 7.0], ["submit", 1.0]]


def ev(name, start, end, cuda=False, id=0, link=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start * 1e6,
                                                                 end=end * 1e6),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           id=id, linked_correlation_id=link)


def test_from_events_places_ops_by_their_launch_and_takes_the_record_ids():
    from gaze_tpu_torch.utils.profiling import Span

    events = [ev("gaze.serve.stage", 0.0, 1.0, id=1), ev("gaze.serve.stage", 2.0, 3.0, id=2),
              ev("gaze.serve.stage", 2.0, 9.0, cuda=True),     # its device-side copy
              ev("aten::copy_", 2.5, 2.9, id=40),
              ev("cudaLaunchKernel", 0.5, 0.6, id=500, link=0),
              ev("kernel_a", 5.0, 6.0, cuda=True, id=500),      # by its runtime call
              ev("Memcpy HtoD", 6.0, 6.5, cuda=True, id=501, link=40),   # by its op
              ev("kernel_b", 7.0, 7.25, cuda=True, id=502, link=0)]      # unlinked
    rec = SimpleNamespace(spans=[Span("serve.stage", 0, 1, -1, {"tick": 4}),
                                 Span("serve.stage", 2, 3, -1, {"tick": 5})],
                          counters={"serve.ticks": 2})
    pt, held = ps.from_events(events, rec)
    assert held == {"serve.stage": 2}
    assert [(n, i["tick"]) for n, _, _, i in pt.spans] == [("serve.stage", 4),
                                                          ("serve.stage", 5)]
    assert [(n, i) for n, _, _, i in pt.ops] == [("kernel_a", 0), ("Memcpy HtoD", 1),
                                                 ("kernel_b", -1)]
    assert pt.unlinked == 1 and pt.counters == {"serve.ticks": 2}
    assert ps.from_events(events[:1], rec)[0].spans == []   # counts differ: no spans
