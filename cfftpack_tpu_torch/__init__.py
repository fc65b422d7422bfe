"""cfftpack_tpu_torch: the PyTorch and CUDA port of cfftpack_tpu.

The same public names and signatures as ``cfftpack_tpu``: complex and
real FFTs in 1-D, 2-D and N-D (tensor and split (re, im) forms), the fused real filter, DCT/DST types I-VIII with
their N-D forms, the generalized DFT, spectrum shifts, frequency grids,
circular convolution, fast-size planning, the ``*_hp`` names in native
float64 with the f64 policy names, the reference-shaped plan API
(``compat``), the finance models (``models``: the conv pricer, the
Monte-Carlo and QMC pricers, the short-rate lattice; ``apps`` re-exports
them), their numerics and the plan, profiling and NaN-check utils
(``utils``), and the parallel layer over ``torch.distributed``
(``cfftpack_tpu_torch.parallel``: mesh helpers, batch-sharded,
four-step, sharded 2-D and row-column transforms, one process a rank;
``dryrun`` drives it on n ranks).  Transforms run through the
hand-written CUDA kernels in ``csrc/`` on CUDA tensors and through their
plain PyTorch versions on CPU tensors.  This package never imports JAX.
"""
from .config import (DEFAULT_NORM, VALID_NORMS,  # noqa: F401
                     set_f64_policy, f64_policy)
from .plan import (fft_next_fast_size, fft_next_fast_even_size,  # noqa: F401
                   fft_next_fast_size_2nm1, fft_next_fast_size_2np1)
from .ops import (fft, ifft, fft2, ifft2, fftn, ifftn,  # noqa: F401
                  fft_split, ifft_split, fft2_split, ifft2_split,
                  rfft, irfft, rfft2, irfft2, rfft_split, irfft_split,
                  rfft2_split, irfft2_split, rfilter_split,
                  dct, idct, dst, idst, dctn, idctn, dstn, idstn,
                  gdft, igdft, gdft_split, igdft_split,
                  fftshift, ifftshift, fftfreq, rfftfreq,
                  circular_convolve,
                  fft_hp, ifft_hp, fft2_hp, ifft2_hp, sfft_hp,
                  rfft_hp, irfft_hp, rfft2_hp, irfft2_hp,
                  dct2_hp, idct2_hp, dst2_hp, idst2_hp,
                  dct4_hp, idct4_hp, dst4_hp, idst4_hp,
                  dct1_hp, idct1_hp, dst1_hp, idst1_hp,
                  dct_hp, idct_hp, dst_hp, idst_hp,
                  dctn_hp, idctn_hp, dstn_hp, idstn_hp,
                  gdft_hp, igdft_hp)

__version__ = "0.6.0"
