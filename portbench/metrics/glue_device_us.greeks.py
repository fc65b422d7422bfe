"""glue_device_us.greeks: device time a call of every kernel that is not one
of the port's csrc kernels: the step's multiply by the filter, and the
real route's packing, merge and unmerge where ops/core.py leaves them
outside K1."""
from portbench import readers


def read(run):
    return readers.glue_us(run)
