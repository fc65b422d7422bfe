"""k1_device_us.dct: device time a call of K1 (k1_stockham_kernel,
k1_reg_kernel in csrc/stockham_fft.cu): the 24 half-length transforms
and real modes of a dctsuite call."""
from portbench import readers


def read(run):
    return readers.kernel_us(run, ("k1_stockham_kernel", "k1_reg_kernel"))
