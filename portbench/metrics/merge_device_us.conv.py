"""merge_device_us.conv: device time a call of the kernels launched inside
the program's cfftpack.merge spans: core._srfft's packed merge (flips,
the 4-term table multiply, DC and Nyquist, the cats) and _sirfft's
unmerge."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.merge")
