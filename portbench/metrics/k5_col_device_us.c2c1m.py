"""k5_col_device_us.c2c1m: device time a call of K5's column pass
(sf_split_col_reg_kernel, or sf_split_col_kernel off the register route,
in csrc/stream_fft.cu): the split's butterfly and twiddle in the load,
the m-point transforms."""
from portbench import readers


def read(run):
    return readers.kernel_us(run, ("sf_split_col_reg_kernel",
                                   "sf_split_col_kernel"))
