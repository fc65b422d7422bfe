"""unpack_device_us.c2c1m: device time a call of the kernels launched
inside the program's cfftpack.unpack spans: torch.complex of K5's output
planes in cfft._fft_impl."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.unpack")
