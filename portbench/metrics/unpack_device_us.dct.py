"""unpack_device_us.dct: device time a call of the kernels launched
inside the program's cfftpack.unpack spans: ops/dct.py's riffles,
interleaves and cats after the last table multiply, the DST's output
flip or sign, and the real inverse's interleave (ops/core.py)."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.unpack")
