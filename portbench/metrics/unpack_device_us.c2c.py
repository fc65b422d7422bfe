"""unpack_device_us.c2c: device time a call of the kernels launched inside
the program's cfftpack.unpack spans: torch.complex of the split planes
in cfft._fft_impl."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.unpack")
