"""exchange_device_us.fft2: device time a call of NCCL's kernels on rank 0:
the two tiled all-to-alls of parallel/_comm.py (rows to columns and
back)."""
from portbench import readers


def read(run):
    return readers.nccl_us(run)
