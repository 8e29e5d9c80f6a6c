"""An edit's seconds outside the UNet loops' stages."""

from portbench import reduce


def read(rec):
    return reduce.non_unet_s(rec)
