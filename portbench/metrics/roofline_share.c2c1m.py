"""roofline_share.c2c1m: a call's ideal bytes (counts/c2c1m.py) at the
card's peak bandwidth (peaks.json) over the call's summed kernel time,
in percent."""
from portbench import readers


def read(run):
    return readers.roofline_pct(run)
