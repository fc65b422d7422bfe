"""k6_device_us.fft2: device time a call of K6 (cf_kernel, cf_reg_kernel in
csrc/col_fft.cu): the column pass at n0 in the natural layout."""
from portbench import readers


def read(run):
    return readers.kernel_us(run, ("cf_kernel", "cf_reg_kernel"))
