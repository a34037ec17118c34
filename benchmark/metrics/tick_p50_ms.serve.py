"""Median of the same samples as ``tick_p95_ms``: due time to the return of
the call that hands back the frame's gaze (host clock, ms)."""

from benchmark.tracing import percentile


def read(run, info):
    return percentile(info["tick_ms"], 50)
