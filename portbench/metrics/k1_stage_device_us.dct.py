"""k1_stage_device_us.dct: device time a call of K1's stage-loop kernel
(k1_stockham_kernel in csrc/stockham_fft.cu) alone: the half lengths 500
and 625, which K1 runs outside its register lengths."""
from portbench import readers


def read(run):
    return readers.kernel_us(run, ("k1_stockham_kernel",))
