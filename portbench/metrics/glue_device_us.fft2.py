"""glue_device_us.fft2: device time a call of the kernels that are neither
the port's csrc kernels nor NCCL's: the exchanges' packs and unpacks
(parallel/_comm.py)."""
from portbench import readers


def read(run):
    return readers.glue_us(run)
