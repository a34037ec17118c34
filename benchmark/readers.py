"""What the per-layer metric readers (``metrics/<name>.py``) share.

Each reader is ``read(run, info) -> float or None``: ``run.device_trace``
is the traced span's ``tracing.DeviceTrace``, ``info`` what the kind
reported of the span (``steps``: model steps, ``batch``, ``units``: clips,
ticks or train steps, and host samples). Shares are percentages. A
reader that finds nothing to read returns None, and the metric is left
out of the line; a roofline is never read as 0.
"""

from __future__ import annotations

from typing import Optional

from benchmark.roofline import counts

STEP_BOUNDS = {"warp3": counts.k1_step, "tvl1_pd": counts.k2_step, "conv3x3_int8": counts.k3_step}


def idle_share(run, info) -> float:
    dt = run.device_trace
    return 100.0 * (1.0 - dt.busy_s() / dt.wall_s)


def roofline(run, info, kernel: str) -> Optional[float]:
    """The kernel's least time over its device time, in percent, over the
    traced span's launches; None where it did not run. Its launches must
    be the count's launches per step times the steps."""
    per_step = STEP_BOUNDS[kernel](run.config, info["batch"])
    seconds, launches = run.device_trace.kernel(kernel)
    if launches == 0:
        return None
    if launches != len(per_step) * info["steps"]:
        raise RuntimeError(f"{kernel}: {launches} launches traced in {info['steps']} steps, "
                           f"the count gives {len(per_step)} a step")
    return 100.0 * sum(t for _, t in per_step) * info["steps"] / seconds


def mfu(run, info, train: bool = False) -> float:
    """The step's least model-arithmetic time over its measured time (the
    traced span's wall over its steps), in percent."""
    least = counts.step_least_s(run.config, info["batch"], train)
    return 100.0 * least * info["steps"] / run.device_trace.wall_s
