"""glue_device_us.conv: device time a call of every kernel that is not one
of the port's csrc kernels (ops/core.py's packing, merge and unmerge,
the step's multiply)."""
from portbench import readers


def read(run):
    return readers.glue_us(run)
