"""launch_host_us.c2c1m: host time a call inside the program's cfftpack.K*
spans (ops/_build.call: K5's C entry, its two launches included), from
the traced stretch."""
from portbench import spans


def read(run):
    return spans.kernel_host_us(run)
