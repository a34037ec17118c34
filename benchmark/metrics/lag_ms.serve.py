"""95th percentile of how late the generator handed each frame to ``submit()``
after its due time (host clock, ms), over the window's ticks."""

from benchmark.tracing import percentile


def read(run, info):
    return percentile(info["lag_ms"], 95)
