"""roofline_share.fft2: a rank's ideal bytes a call (counts/fft2_4096.py)
at the card's peak bandwidth (peaks.json) over the call's summed kernel
time, NCCL's included, in percent."""
from portbench import readers


def read(run):
    return readers.roofline_pct(run)
