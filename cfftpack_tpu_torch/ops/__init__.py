"""The public transforms, each behind the API layer's exit
(``utils.debug.api_exit``: the NaN check while it is on)."""
import inspect as _inspect

from .cfft import (fft, ifft, fft2, ifft2, fftn, ifftn,  # noqa: F401
                   fft_split, ifft_split, fft2_split, ifft2_split)
from .rfft import (rfft, irfft, rfft2, irfft2, rfft_split,  # noqa: F401
                   irfft_split, rfft2_split, irfft2_split, rfilter_split)
from .dct import dct, idct, dst, idst, dctn, idctn, dstn, idstn  # noqa: F401
from .gdft import gdft, igdft, gdft_split, igdft_split  # noqa: F401
from .shift import fftshift, ifftshift  # noqa: F401
from .freq import fftfreq, rfftfreq, circular_convolve  # noqa: F401
from .hp import (fft_hp, ifft_hp, fft2_hp, ifft2_hp,  # noqa: F401
                 sfft_hp,
                 rfft_hp, irfft_hp, rfft2_hp, irfft2_hp, dct2_hp, idct2_hp,
                 dst2_hp, idst2_hp, dct4_hp, idct4_hp,
                 dst4_hp, idst4_hp, dct1_hp, idct1_hp,
                 dst1_hp, idst1_hp, dct_hp, idct_hp,
                 dst_hp, idst_hp,
                 dctn_hp, idctn_hp, dstn_hp, idstn_hp,
                 gdft_hp, igdft_hp)

from ..utils.debug import api_exit as _api_exit  # noqa: E402

for _name, _fn in list(globals().items()):
    if _inspect.isfunction(_fn) and not _name.startswith("_"):
        globals()[_name] = _api_exit(_fn)
