"""A single edit's UNet loops' seconds over their steps (ms)."""

from portbench import reduce


def read(rec):
    return reduce.unet_step_ms(rec)
