"""K1's least time over its device time in the profiled edit (%)."""

from portbench import reduce


def read(rec):
    return reduce.roofline(rec, "k1")
