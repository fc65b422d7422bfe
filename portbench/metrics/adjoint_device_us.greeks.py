"""adjoint_device_us.greeks: device time a call of the kernels launched
inside the program's cfftpack.adjoint spans (ops/_adjoint.py, on
autograd's device thread): the kernels' backward, the rest of the
backward being autograd's own through the glue."""
from portbench import readers


def read(run):
    return readers.span_us(run, "cfftpack.adjoint")
