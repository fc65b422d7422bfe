"""filter_device_us.greeks: device time a call of the kernels launched inside
the program's cfftpack.filter span: entry.step's multiply by the
characteristic function."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.filter")
