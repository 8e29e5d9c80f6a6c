"""Model FLOPs served in the window over its seconds at the bf16 peak (%)."""

from portbench import reduce


def read(rec):
    return reduce.mfu(rec)
