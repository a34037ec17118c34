"""Device busy milliseconds per tick over a traced span of ticks at the cell's
rate: the profiler's merged busy time over the span's ticks. At a fixed rate a
faster server idles more, so the busy time, not the idle share, falls with
``tick_p95_ms``."""


def read(run, info):
    return 1e3 * run.device_trace.busy_s() / info["units"]
