"""host_us_per_call.c2c1m: median host time to submit a call of fft then
ifft at 2^20 (ops/cfft.py down to K5's C entry), from the window, outside
the profiler."""
from portbench import readers


def read(run):
    return readers.host_us_per_call(run)
