"""launch_host_us.greeks: host time a call inside the program's cfftpack.K*
spans (ops/_build.call: the C entry, its launches included), from the
traced stretch."""
from portbench import spans


def read(run):
    return spans.kernel_host_us(run)
