"""glue_device_us.dct: device time a call of every kernel that is neither
one of the port's csrc kernels nor NCCL's: ops/dct.py's gathers, table
multiplies, riffles and scales, and the real route's around K1."""
from portbench import readers


def read(run):
    return readers.glue_us(run)
