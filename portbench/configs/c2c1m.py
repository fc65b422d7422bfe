"""c2c1m: the long complex round trip in single precision,
``cfftpack_tpu_torch.fft`` then ``ifft`` on complex64 rows of 2^20 with
FFTPACK scaling; a call returns the spectrum and the reconstruction.
The call and its inputs (standard normal real and imaginary parts from
the run's seed, made on the card) are c2c1024's, at this configuration's
length and dtype."""
from portbench.configs.c2c1024 import make_inputs, program

__all__ = ["make_inputs", "program"]
