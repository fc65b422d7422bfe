"""glue_device_us.c2c: device time a call of every kernel that is not one
of the port's csrc kernels (ops/cfft.py's split and recombination)."""
from portbench import readers


def read(run):
    return readers.glue_us(run)
