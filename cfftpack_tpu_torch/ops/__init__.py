from .cfft import fft, ifft, fft_split, ifft_split  # noqa: F401
from .rfft import (rfft, irfft, rfft_split, irfft_split,  # noqa: F401
                   rfilter_split)
from .dct import dct, idct, dst, idst, dctn, idctn, dstn, idstn  # noqa: F401
