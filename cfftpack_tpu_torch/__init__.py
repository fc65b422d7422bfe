"""cfftpack_tpu_torch: the PyTorch and CUDA port of cfftpack_tpu.

The same public names and signatures as ``cfftpack_tpu`` for the part
ported so far: complex and real FFTs in 1-D, 2-D and N-D (tensor and
split (re, im) forms), the fused real filter, DCT/DST types I-VIII with
their N-D forms, the generalized DFT, spectrum shifts, frequency grids,
circular convolution, fast-size planning and the conv option pricer
(``cfftpack_tpu_torch.models``).  Transforms run through the
hand-written CUDA kernels in ``csrc/`` on CUDA tensors and through their
plain PyTorch versions on CPU tensors.  This package never imports JAX.
"""
from .config import DEFAULT_NORM, VALID_NORMS  # noqa: F401
from .plan import (fft_next_fast_size, fft_next_fast_even_size,  # noqa: F401
                   fft_next_fast_size_2nm1, fft_next_fast_size_2np1)
from .ops import (fft, ifft, fft2, ifft2, fftn, ifftn,  # noqa: F401
                  fft_split, ifft_split, fft2_split, ifft2_split,
                  rfft, irfft, rfft2, irfft2, rfft_split, irfft_split,
                  rfft2_split, irfft2_split, rfilter_split,
                  dct, idct, dst, idst, dctn, idctn, dstn, idstn,
                  gdft, igdft, gdft_split, igdft_split,
                  fftshift, ifftshift, fftfreq, rfftfreq,
                  circular_convolve)

__version__ = "0.4.0"
