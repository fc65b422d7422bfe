"""conv_call_p95_ms: the 95th percentile of a call's time, submission to
the host's observing its completion, over every call of the window."""
from portbench import readers


def read(run):
    return readers.call_p95_ms(run)
