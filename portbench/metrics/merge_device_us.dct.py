"""merge_device_us.dct: device time a call of the kernels launched inside
the program's cfftpack.merge spans: ops/dct.py's table multiplies on
either side of K1 (DCT-II's post-FFT FMA, DCT-III's pre-FFT FMA, DCT-IV's
rotations) and the real route's merge and unmerge (ops/core.py)."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.merge")
