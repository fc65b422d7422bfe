"""host_us_per_call.conv: median host time to submit a call of the step
(entry.py, ops/rfft.py), from the window, outside the profiler."""
from portbench import readers


def read(run):
    return readers.host_us_per_call(run)
