"""k5_row_device_us.c2c1m: device time a call of K5's row pass
(sf_split_row_kernel in csrc/stream_fft.cu): the 128-point rows, the
riffle and the scale in the store."""
from portbench import readers


def read(run):
    return readers.kernel_us(run, ("sf_split_row_kernel",))
