"""The SP train step's share of the chip's peak (%): forward and backward
model arithmetic at the stated precision over the measured wall time per step."""

from benchmark.readers import mfu


def read(run, info):
    return mfu(run, info, train=True)
