"""host_us_per_call.c2c: median host time to submit a call of fft then ifft
(ops/cfft.py), from the window, outside the profiler."""
from portbench import readers


def read(run):
    return readers.host_us_per_call(run)
