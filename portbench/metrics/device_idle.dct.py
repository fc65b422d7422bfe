"""device_idle.dct: 1 - the union of device-op intervals over the traced
window, in percent."""
from portbench import readers


def read(run):
    return readers.idle_pct(run)
