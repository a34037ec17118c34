"""Device milliseconds of the host-to-device copies per clip (the profiler's
``Memcpy HtoD``): ``run_clip`'s upload of the clip's frames."""


def read(run, info):
    seconds, n = run.device_trace.ops_matching("Memcpy HtoD")
    return 1e3 * seconds / info["units"] if n else None
