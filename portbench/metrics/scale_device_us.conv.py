"""scale_device_us.conv: device time a call of the kernels launched inside
the program's cfftpack.scale spans: the norm's multiplies that no kernel
store takes (core.srfft, core.sirfft)."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.scale")
