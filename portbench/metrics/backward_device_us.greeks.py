"""backward_device_us.greeks: device time a call of the kernels launched
inside the benchmark's portbench.backward span around
torch.autograd.grad."""
from portbench import readers


def read(run):
    return readers.span_us(run, "portbench.backward")
