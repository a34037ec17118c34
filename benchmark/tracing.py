"""Host spans and the device trace of a traced span.

``Spans`` times the benchmark's own calls into the program on the host
clock (``generate``, ``wait_due``, ``submit``, ``flush``, ``run_clip``,
``gaze_to_host``, ``train_step``) and, while a trace is taken, marks them
in it with ``torch.profiler.record_function`` so the idle gaps of the
device can be put down to what the host was doing.

``device_trace`` is the port's ``chip_smoke.py:device_profile`` copied
and cut to what the benchmark reads: the traced call runs under
``torch.profiler`` with the CPU and CUDA activities; a trace counts only
where it holds device events and exactly the launches of each of the
port's kernels that the port's own counters counted in the call. The
profiler drops device records that fall outside its window as a
process ages, so an incomplete trace is taken again in a wider window;
a trace that never comes back whole is an error, and no figure is read
from it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

# Each of the port's kernels by its counter's name, and the part of its
# device function's name that a trace shows.
KERNEL_NAMES = {"warp3": "warp3_kernel", "tvl1_pd": "pd_iterations_kernel",
                "conv3x3_int8": "conv3x3_int8_kernel"}
# Idle seconds before and after the traced call, per try.
PADS_S = (0.0, 0.2, 0.5, 1.0)
SPAN_PREFIX = "bench."


class Spans:
    """Host-clock spans by name, kept in memory: (start, end) seconds of
    ``time.perf_counter``."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = {}
        self.marking = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = None
        if self.marking:
            import torch

            mark = torch.profiler.record_function(SPAN_PREFIX + name)
            mark.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.by_name.setdefault(name, []).append((t0, time.perf_counter()))
            if mark is not None:
                mark.__exit__(None, None, None)


class DeviceTrace:
    """What one traced call left: per device op name (seconds, count),
    the merged busy intervals and the host spans, all in seconds on the
    trace's clock, and the traced call's wall seconds."""

    def __init__(self, ops, intervals, host_spans, wall_s):
        self.ops: Dict[str, Tuple[float, int]] = ops
        self.intervals: List[Tuple[float, float]] = intervals
        self.host_spans: List[Tuple[str, float, float]] = host_spans
        self.wall_s = wall_s

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals)

    def kernel(self, counter: str) -> Tuple[float, int]:
        """(device seconds, launches) of the port's kernel ``counter``."""
        hits = [v for k, v in self.ops.items() if KERNEL_NAMES[counter] in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def ops_matching(self, part: str) -> Tuple[float, int]:
        hits = [v for k, v in self.ops.items() if part in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def top_ops(self, n: int = 10) -> List[List]:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:n]
        return [[k[:120], v[0]] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between device work inside the traced
        call, each named by the innermost benchmark span open at its
        middle (``none`` where none was)."""
        gaps = []
        t_lo = min((s for _, s, _ in self.host_spans), default=None)
        for (s0, e0), (s1, _) in zip(self.intervals, self.intervals[1:]):
            gaps.append((e0, s1))
        if t_lo is not None and self.intervals and self.intervals[0][0] > t_lo:
            gaps.append((t_lo, self.intervals[0][0]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = [(e - s, name) for name, s, e in self.host_spans if s <= mid <= e]
            out.append([min(open_)[1] if open_ else "none", b - a])
        return out


def launch_counts() -> Dict[str, int]:
    from gaze_tpu_torch.ops import cuda

    return {name: k.launches for name, k in cuda.kernels().items()}


def device_trace(fn: Callable[[], None], spans: Spans) -> DeviceTrace:
    """Run ``fn`` under the profiler until a trace holds every launch the
    port's counters count; raise where none does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    last = None
    for pad in PADS_S:
        torch.cuda.synchronize()
        before = launch_counts()
        spans.marking = True
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(pad)
        finally:
            spans.marking = False
        counted = {k: v - before[k] for k, v in launch_counts().items()}
        ops: Dict[str, Tuple[float, int]] = {}
        raw, host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                if e.device_type != DeviceType.CUDA:   # its device-side copy is no device work
                    host.append((e.name[len(SPAN_PREFIX):], tr.start / 1e6, tr.end / 1e6))
            elif e.device_type == DeviceType.CUDA:
                sec, n = ops.get(e.name, (0.0, 0))
                ops[e.name] = (sec + tr.elapsed_us() / 1e6, n + 1)
                raw.append((tr.start / 1e6, tr.end / 1e6))
        trace = DeviceTrace(ops, merge(raw), host, wall)
        traced = {k: trace.kernel(k)[1] for k in counted}
        if ops and traced == counted:
            return trace
        last = (len(ops), traced, counted)
    raise RuntimeError(f"no complete trace in {len(PADS_S)} tries: {last[0]} device ops, "
                       f"launches {last[1]} traced against {last[2]} counted")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, overlapping intervals merged."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile of ``values`` by linear interpolation
    (numpy's default), None for no values."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None
