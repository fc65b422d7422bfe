"""roofline_share.dct: a call's ideal bytes (counts/dctsuite.py) at the
card's peak bandwidth (peaks.json) over the call's summed kernel time,
in percent."""
from portbench import readers


def read(run):
    return readers.roofline_pct(run)
