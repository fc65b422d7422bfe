"""device_idle.fft2: 1 - the union of device-op intervals over rank 0's
traced window, in percent."""
from portbench import readers


def read(run):
    return readers.idle_pct(run)
