"""K3's share of its roofline over a traced span of whole clips (%): the
least time of its launches by ``roofline/counts.py`` over its device time."""

from benchmark.readers import roofline


def read(run, info):
    return roofline(run, info, "conv3x3_int8")
