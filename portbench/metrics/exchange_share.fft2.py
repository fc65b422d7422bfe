"""exchange_share.fft2: a rank's bytes sent over the links a call
(counts/fft2_4096.py) at the card's NVLink peak a direction (peaks.json)
over NCCL's kernel time a call, in percent."""
from portbench import readers


def read(run):
    return readers.exchange_pct(run)
