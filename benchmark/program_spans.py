"""The program's own spans in a traced span, on the trace's clock.

The port records spans and counters inside itself
(``gaze_tpu_torch/utils/profiling.py``) while a ``recording()`` is open,
and each span is then a ``gaze.*`` event of an active
``torch.profiler`` session. ``from_events(events, record)`` takes a
traced call's ``prof.events()`` and the program's ``Record`` of the same
call, and keeps:

- the program's spans with their ids (the k-th ``gaze.X`` event of the
  trace is the record's k-th span ``X``), in seconds on the trace's
  clock;
- every device op (kernel, memcpy, memset) with the innermost program
  span open on the host at its launch: the profiler correlates the op
  with its runtime launch call (else with the op that made the call),
  whose host time is looked up among the spans. Launches from autograd's
  threads fall inside the step's ``train.backward`` by time, as every
  launch is placed by time alone;
- the program's counters over the call, and the span counts the trace
  holds, for a completeness check against the record.

The readers below read one ``ProgramTrace`` and raise where the spans
disagree with the program's own counters. ``tracing.py`` opens no
recording and keeps no program span, so no metric of ``BENCHMARK.json``
reads these yet (``PERF.md`` §7 gives the edit that wires them in).
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.tracing import percentile

PROGRAM_PREFIX = "gaze."
# Host calls that launch device work: CUDA runtime and driver calls.
LAUNCH_PREFIX = "cu"

Interval = Tuple[str, float, float]


class ProgramTrace:
    """A traced call's program spans (name, start, end, ids; in the order
    they opened), each one's parent (the innermost span around it, -1 at
    the top), and every device op (name, start, end, the span it was
    launched in or -1), seconds on the trace's clock; the program's
    counters over the call."""

    def __init__(self, spans: Sequence[Tuple[str, float, float, Dict]],
                 ops: Sequence[Tuple[str, float, float, float]],
                 counters: Optional[Dict[str, int]] = None, unlinked: int = 0):
        order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
        self.spans = [spans[i] for i in order]
        self.parents = _parents(self.spans)
        self.counters = dict(counters or {})
        self.unlinked = unlinked   # device ops whose launch the trace did not hold
        starts = [s[1] for s in self.spans]
        self.ops = [(name, s, e, self._innermost(starts, t)) for name, s, e, t in ops]

    def _innermost(self, starts: List[float], t: float) -> int:
        """The innermost span open at host time ``t``, -1 where none is."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and self.spans[i][2] < t:
            i = self.parents[i]
        return i

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def host_s(self, name: str) -> float:
        """Host seconds inside the spans ``name``."""
        return sum(e - s for n, s, e, _ in self.spans if n == name)

    def _within(self, i: int, name: str) -> bool:
        while i >= 0:
            if self.spans[i][0] == name:
                return True
            i = self.parents[i]
        return False

    def device_s(self, name: str, children: bool = True) -> float:
        """Device seconds of the ops launched inside the spans ``name``:
        their children's launches included, or (``children=False``) the
        span's own alone."""
        if children:
            return sum(e - s for _, s, e, i in self.ops if self._within(i, name))
        return sum(e - s for _, s, e, i in self.ops if i >= 0 and self.spans[i][0] == name)

    def gaps_s(self, first: str, second: str, key: str = "tick") -> List[float]:
        """Per id ``key``: the start of the span ``second`` less the end of
        the span ``first`` that carries the same id (ids found in both)."""
        ends = {ids[key]: e for n, _, e, ids in self.spans if n == first and key in ids}
        return [s - ends[ids[key]] for n, s, _, ids in self.spans
                if n == second and ids.get(key) in ends]


def _parents(spans) -> List[int]:
    """Each span's innermost enclosing span, by time (spans sorted by
    start, the longer first at a tie)."""
    parents, stack = [], []
    for i, (_, s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][2] < e:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        stack.append(i)
    return parents


def from_events(events, record) -> Tuple[ProgramTrace, Dict[str, int]]:
    """A ``ProgramTrace`` of a profiler's ``events()`` and the program's
    ``Record`` of the same call, and the span counts the trace holds by
    name (for the completeness check)."""
    from torch.autograd import DeviceType

    gaze, ops, launch, linked = [], [], {}, {}
    for e in events:
        tr, on_card = e.time_range, e.device_type == DeviceType.CUDA
        s, t = tr.start / 1e6, tr.end / 1e6
        if e.name.startswith(PROGRAM_PREFIX):
            if not on_card:   # its device-side copy is no device work
                gaze.append((e.name[len(PROGRAM_PREFIX):], s, t))
        elif on_card:
            ops.append((e.name, s, t, e.id, getattr(e, "linked_correlation_id", 0)))
        elif e.name.startswith(LAUNCH_PREFIX):
            launch[e.id] = s
        else:
            linked.setdefault(e.id, s)
    held = Counter(name for name, _, _ in gaze)
    spans = _with_ids(gaze, record.spans) if held == _record_counts(record) else []
    placed, unlinked = [], 0
    for name, s, t, corr, link in ops:
        at = launch.get(corr, linked.get(link) if link else None)
        if at is None:
            unlinked += 1
            at = float("-inf")
        placed.append((name, s, t, at))
    return ProgramTrace(spans, placed, record.counters, unlinked), held


def _record_counts(record) -> Counter:
    return Counter(s.name for s in record.spans)


def _with_ids(events: List[Interval], recorded) -> List[Tuple[str, float, float, Dict]]:
    """Trace events with the ids of the recorded spans of the same name,
    the k-th event (by start) taking the k-th span's."""
    ids: Dict[str, List[Dict]] = {}
    for s in recorded:
        ids.setdefault(s.name, []).append(s.ids)
    taken: Dict[str, int] = {}
    out = []
    for name, s, e in sorted(events, key=lambda x: x[1]):
        k = taken.get(name, 0)
        taken[name] = k + 1
        out.append((name, s, e, ids[name][k]))
    return out


# ------------------------------------------------------------- readers ----
# The per-layer numbers of each kind by name, and the span each reads.
CLIP_STAGES = {"flow_ms": "step.preprocess", "encode_ms": "sp.encode",
               "decode_ms": "sp.decode", "attend_ms": "step.attend"}
TRAIN_STAGES = {"forward_ms": "train.forward", "backward_ms": "train.backward",
                "optimizer_ms": "train.optimizer"}


def _expect(pt: ProgramTrace, span: str, counter: str, want: Optional[int] = None) -> int:
    """The counter's value over the call; raises unless the span occurs as
    often as the counter counts (and as ``want``, where given)."""
    n = pt.counters.get(counter, 0)
    if pt.count(span) != n or n == 0 or (want is not None and n != want):
        raise RuntimeError(f"{pt.count(span)} spans {span} against the program's {counter} "
                           f"{n}" + ("" if want is None else f" and the kind's {want}"))
    return n


def stage_ms(pt: ProgramTrace, info: dict, span: str) -> float:
    """Device ms a step of the ops launched under ``span`` (a clip step's
    stage), its children included."""
    steps = _expect(pt, "step.preprocess", "pipeline.steps", info["steps"])
    return 1e3 * pt.device_s(span) / steps


def train_ms(pt: ProgramTrace, info: dict, span: str) -> float:
    """Device ms a train step under ``span``, its children included."""
    steps = _expect(pt, "train.optimizer", "train.steps", info["steps"])
    if pt.count(span) != steps:
        raise RuntimeError(f"{pt.count(span)} spans {span} in {steps} train steps")
    return 1e3 * pt.device_s(span) / steps


def queue_ms(pt: ProgramTrace, info: dict) -> float:
    """p95 over the call's ticks of how long a staged batch waited for
    its tick: ``serve.advance``'s start less its ``serve.stage``'s end."""
    ticks = _expect(pt, "serve.advance", "serve.ticks", info["units"])
    gaps = pt.gaps_s("serve.stage", "serve.advance")
    if len(gaps) != ticks:
        raise RuntimeError(f"{len(gaps)} stage/advance pairs in {ticks} ticks")
    return 1e3 * percentile(gaps, 95)


def serve_host_ms(pt: ProgramTrace, info: dict, span: str) -> float:
    """Host ms a tick inside ``span``."""
    ticks = _expect(pt, "serve.advance", "serve.ticks", info["units"])
    return 1e3 * pt.host_s(span) / ticks
