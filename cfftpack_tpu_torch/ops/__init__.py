from .cfft import (fft, ifft, fft2, ifft2, fftn, ifftn,  # noqa: F401
                   fft_split, ifft_split, fft2_split, ifft2_split)
from .rfft import (rfft, irfft, rfft2, irfft2, rfft_split,  # noqa: F401
                   irfft_split, rfft2_split, irfft2_split, rfilter_split)
from .dct import dct, idct, dst, idst, dctn, idctn, dstn, idstn  # noqa: F401
from .gdft import gdft, igdft, gdft_split, igdft_split  # noqa: F401
from .shift import fftshift, ifftshift  # noqa: F401
from .freq import fftfreq, rfftfreq, circular_convolve  # noqa: F401
