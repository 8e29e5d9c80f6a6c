"""The server's time between microbatches, per microbatch (ms)."""

from portbench import reduce


def read(rec):
    return reduce.between_units_ms(rec)
