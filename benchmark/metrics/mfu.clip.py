"""The clip step's share of the chip's peak (%): the least time of one step's model
arithmetic at its stated precisions (``roofline/counts.py``) over the measured
wall time per step of a traced span of whole clips."""

from benchmark.readers import mfu


def read(run, info):
    return mfu(run, info)
