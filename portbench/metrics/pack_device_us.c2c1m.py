"""pack_device_us.c2c1m: device time a call of the kernels launched inside
the program's cfftpack.pack spans: the copies of x.real and x.imag into
K5's row layout (stream_fft._rows)."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.pack")
