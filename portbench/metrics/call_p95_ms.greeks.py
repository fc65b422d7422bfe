"""call_p95_ms.greeks: the 95th percentile of a call's time (the step and
its autograd.grad), submission to the host's observing its completion,
over every call of the window; the host paces the cell, so it swings
from process to process."""
from portbench import readers


def read(run):
    return readers.call_p95_ms(run)
