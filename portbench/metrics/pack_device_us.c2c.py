"""pack_device_us.c2c: device time a call of the kernels launched inside
the program's cfftpack.pack spans: the copies of x.real and x.imag into
K1's row layout (fused_fft._launch)."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.pack")
