"""The ``*_hp`` names in native float64 (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/hp.py``, whose double-float engine
(f32 (hi, lo) pairs) exists because TPUs lack f64.  The card has native
FP64, so each name here is a thin wrapper: it casts its input to
float64 or complex128 and runs the port's own float64 path, which
reaches K1's float64 entry (register passes at 480-4096, the stage loop
elsewhere) and the in-core four-step above K1's cap.  The float32
stream kernels are never reached from here.

Signatures are the reference's: no ``axis``; the last axis, or the last
two for the 2-D forms.  Results are tensors of dtype float64 or
complex128 on the input's device (the reference returns host numpy);
an input that is not a tensor goes to the default device
(``config.as_tensor``).  ``"forward"`` folds onto ``"fftpack"``, and a
length-0 axis raises ``ValueError``.
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_NORM, _check_length, as_tensor, check_norm
from . import core
from .cfft import fft, fft2, ifft, ifft2
from .dct import dct, dctn, dst, dstn, idct, idctn, idst, idstn
from .gdft import gdft, igdft
from .rfft import irfft, irfft2, rfft, rfft2

__all__ = ["fft_hp", "ifft_hp", "fft2_hp", "ifft2_hp", "sfft_hp",
           "rfft_hp", "irfft_hp", "rfft2_hp", "irfft2_hp",
           "dct2_hp", "idct2_hp", "dst2_hp",
           "idst2_hp", "dct4_hp", "idct4_hp", "dst4_hp", "idst4_hp",
           "dct1_hp", "idct1_hp", "dst1_hp", "idst1_hp",
           "dct_hp", "idct_hp", "dst_hp", "idst_hp",
           "dctn_hp", "idctn_hp", "dstn_hp", "idstn_hp",
           "gdft_hp", "igdft_hp"]


def _hp_norm(norm: str) -> str:
    """check_norm, with the ``"forward"`` alias folded onto fftpack."""
    norm = check_norm(norm)
    return "fftpack" if norm == "forward" else norm


def _c128(x):
    return as_tensor(x).to(torch.complex128)


def _f64(x):
    """float64 of a real input (complex raises, as the main API does)."""
    x = as_tensor(x)
    if x.is_complex():
        raise TypeError("real input required, got a complex tensor")
    return x.to(torch.float64)


def sfft_hp(Rh, Rl, Ih, Il, n: int, inverse: bool):
    """Unscaled DFT over the last axis of a (re_hi, re_lo, im_hi, im_lo)
    quad of float32 planes.  Each (hi, lo) pair is summed in float64,
    transformed in float64 and returned as float32 planes
    ``hi = float32(y)``, ``lo = float32(y - hi)``."""
    Rh = as_tensor(Rh)
    _check_length(int(n))
    xr, xi = (as_tensor(h, like=Rh).double() + as_tensor(lo, like=Rh).double()
              for h, lo in ((Rh, Rl), (Ih, Il)))
    yr, yi = core.sfft(xr, xi, int(n), bool(inverse))
    out = []
    for y in (yr, yi):
        hi = y.to(torch.float32)
        out += [hi, (y - hi.double()).to(torch.float32)]
    return tuple(out)


def fft_hp(x, norm: str = DEFAULT_NORM):
    """Forward FFT in complex128 over the last axis."""
    return fft(_c128(x), norm=check_norm(norm))


def ifft_hp(y, norm: str = DEFAULT_NORM):
    return ifft(_c128(y), norm=check_norm(norm))


def fft2_hp(x, norm: str = DEFAULT_NORM):
    """2-D FFT in complex128 over the last two axes."""
    return fft2(_c128(x), norm=check_norm(norm))


def ifft2_hp(y, norm: str = DEFAULT_NORM):
    return ifft2(_c128(y), norm=check_norm(norm))


def rfft_hp(x, norm: str = DEFAULT_NORM):
    """Real FFT in float64: packed (n//2+1) complex128 spectrum."""
    return rfft(_f64(x), norm=check_norm(norm))


def irfft_hp(y, n: int, norm: str = DEFAULT_NORM):
    """Inverse of :func:`rfft_hp`: float64 output of length ``n``."""
    return irfft(_c128(y), int(n), norm=check_norm(norm))


def rfft2_hp(x, norm: str = DEFAULT_NORM):
    """2-D real FFT in float64 over the last two axes."""
    return rfft2(_f64(x), norm=check_norm(norm))


def irfft2_hp(y, s, norm: str = DEFAULT_NORM):
    """Inverse 2-D real FFT in float64; ``s = (n0, n1)``."""
    return irfft2(_c128(y), s, norm=check_norm(norm))


def _trig(fn, x, t: int, norm: str):
    return fn(_f64(x), t, norm=_hp_norm(norm))


def dct_hp(x, type: int = 2, norm: str = DEFAULT_NORM):
    """Forward DCT of any type 1-8 in float64, the pairing and scaling
    of ``dct``."""
    return _trig(dct, x, type, norm)


def idct_hp(y, type: int = 2, norm: str = DEFAULT_NORM):
    """Inverse DCT of any type 1-8: idct_hp(dct_hp(x, t), t) == x."""
    return _trig(idct, y, type, norm)


def dst_hp(x, type: int = 2, norm: str = DEFAULT_NORM):
    """Forward DST of any type 1-8 in float64."""
    return _trig(dst, x, type, norm)


def idst_hp(y, type: int = 2, norm: str = DEFAULT_NORM):
    return _trig(idst, y, type, norm)


def dct1_hp(x, norm: str = DEFAULT_NORM):
    return dct_hp(x, 1, norm)


def idct1_hp(y, norm: str = DEFAULT_NORM):
    return idct_hp(y, 1, norm)


def dct2_hp(x, norm: str = DEFAULT_NORM):
    return dct_hp(x, 2, norm)


def idct2_hp(y, norm: str = DEFAULT_NORM):
    return idct_hp(y, 2, norm)


def dct4_hp(x, norm: str = DEFAULT_NORM):
    return dct_hp(x, 4, norm)


def idct4_hp(y, norm: str = DEFAULT_NORM):
    return idct_hp(y, 4, norm)


def dst1_hp(x, norm: str = DEFAULT_NORM):
    return dst_hp(x, 1, norm)


def idst1_hp(y, norm: str = DEFAULT_NORM):
    return idst_hp(y, 1, norm)


def dst2_hp(x, norm: str = DEFAULT_NORM):
    return dst_hp(x, 2, norm)


def idst2_hp(y, norm: str = DEFAULT_NORM):
    return idst_hp(y, 2, norm)


def dst4_hp(x, norm: str = DEFAULT_NORM):
    return dst_hp(x, 4, norm)


def idst4_hp(y, norm: str = DEFAULT_NORM):
    return idst_hp(y, 4, norm)


def dctn_hp(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    """N-D DCT in float64; ``dctn_hp(x, 3, axes=(-2, -1))`` is the
    reference's ``dct_2d_forward``."""
    return dctn(_f64(x), type, axes, _hp_norm(norm))


def idctn_hp(y, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return idctn(_f64(y), type, axes, _hp_norm(norm))


def dstn_hp(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return dstn(_f64(x), type, axes, _hp_norm(norm))


def idstn_hp(y, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return idstn(_f64(y), type, axes, _hp_norm(norm))


def gdft_hp(x, a: float = 0.0, b: float = 0.0, norm: str = DEFAULT_NORM):
    """Generalized DFT in complex128:
    y[k] = scale * sum_j x[j] e^{-2i pi (j+a)(k+b)/n}."""
    return gdft(_c128(x), a, b, norm=check_norm(norm))


def igdft_hp(y, a: float = 0.0, b: float = 0.0, norm: str = DEFAULT_NORM):
    """True inverse of :func:`gdft_hp`."""
    return igdft(_c128(y), a, b, norm=check_norm(norm))
