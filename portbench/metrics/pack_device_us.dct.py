"""pack_device_us.dct: device time a call of the kernels launched inside
the program's cfftpack.pack spans: ops/dct.py's Makhoul gathers, cats and
flips and the DST's input sign or flip, and K1's copies of strided rows
(ops/fused_fft.py)."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.pack")
