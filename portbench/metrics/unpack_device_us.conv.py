"""unpack_device_us.conv: device time a call of the kernels launched inside
the program's cfftpack.unpack spans: core._sirfft's interleave of the
inverse's planes into real rows."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.unpack")
