"""host_us_per_call.greeks: median host time to submit a call of the step
and its backward (entry.py, ops/rfft.py, autograd's launches through
ops/_adjoint.py), from the window, outside the profiler."""
from portbench import readers


def read(run):
    return readers.host_us_per_call(run)
