"""The share of the profiled microbatch with no kernel running (%)."""

from portbench import reduce


def read(rec):
    return reduce.idle_share(rec)
