"""host_us_per_call.dct: median host time to submit a dctsuite call (the
API's checks, ops/dct.py's and ops/core.py's glue, 24 K1 C entries),
from the window, outside the profiler."""
from portbench import readers


def read(run):
    return readers.host_us_per_call(run)
