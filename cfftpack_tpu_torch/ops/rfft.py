"""Real FFT (r2c / c2r) and the fused real filter (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/rfft.py``.  Packed (n//2+1)-bin
spectrum with imag(DC) == 0 and, for even n, imag(Nyquist) == 0, the
reference's ``rfft_forward``/``rfft_inverse`` layout.  Scaling follows
the complex path: the unscaled cores satisfy
``sirfft(srfft(x)) == n*x`` and the public API hands its norm's scale
to them (the K7 route applies it in the kernel's store).
The 2-D forms run r2c along the last of their axes and a complex pass
along the first, which for the trailing pair of float32 planes is K6 on
the n1//2 + 1 packed columns as they stand (the kernel masks its last
lane group, so the ragged width needs no pad).  This module checks and
coerces the input and turns the norm into a scale; the routes of
``core.srfft``, ``core.sirfft`` and ``core.srfilter`` choose the
kernels.
"""
from __future__ import annotations

import torch

from ..config import (DEFAULT_NORM, _apply_axis, _as_real_plane, _check_axis,
                      _check_length, as_tensor, check_norm, complex_dtype_of,
                      fwd_scale, inv_scale, real_dtype_of)
from ..utils.profiling import span
from . import core
from .cfft import fft, fft_split, ifft, ifft_split

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfft_split", "irfft_split",
           "rfft2_split", "irfft2_split", "rfilter_split"]


def rfft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Real-to-complex forward FFT: (..., n) real -> (..., n//2+1) complex.

    Packed layout and FFTPACK 1/n forward scaling match the reference's
    ``rfft_forward``.  Any length n is supported.
    """
    norm = check_norm(norm)
    x = _as_real_plane(as_tensor(x), "rfft")
    _check_axis(x, axis)
    n = x.shape[axis]
    _check_length(n)

    s = fwd_scale(norm, n)

    def core_fn(v):
        yr, yi = core.srfft(v, n, s)
        with span("cfftpack.unpack"):
            return torch.complex(yr, yi)

    return _apply_axis(x, axis, core_fn)


def irfft(y, n: int, axis: int = -1, norm: str = DEFAULT_NORM):
    """Complex-to-real inverse FFT of a packed (n//2+1)-bin spectrum.

    ``n`` is the real output length (the packed layout is ambiguous
    about parity, so it must be given).
    """
    norm = check_norm(norm)
    n = int(n)
    y = as_tensor(y)
    _check_axis(y, axis)
    y = y.to(complex_dtype_of(y.dtype))
    if y.shape[axis] != n // 2 + 1:
        raise ValueError(
            f"irfft: spectrum axis has {y.shape[axis]} bins, expected "
            f"n//2+1 = {n // 2 + 1} for n={n}")
    rdtype = real_dtype_of(y.dtype)
    s = inv_scale(norm, n)
    return _apply_axis(y, axis, lambda v: core.sirfft(
        v.real.to(rdtype), v.imag.to(rdtype), n, s))


def rfft2(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D real FFT -> (..., n0, n1//2+1) packed complex spectrum: r2c
    along ``axes[1]``, then a complex FFT along ``axes[0]`` (the order
    of the reference's ``rfft2f_``)."""
    norm = check_norm(norm)
    a0, a1 = (int(a) for a in axes)
    return fft(rfft(x, a1, norm), a0, norm)


def irfft2(y, s, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse 2-D real FFT; ``s = (n0, n1)`` is the real output shape."""
    norm = check_norm(norm)
    a0, a1 = (int(a) for a in axes)
    n0, n1 = int(s[0]), int(s[1])
    y = as_tensor(y)
    if y.shape[a0] != n0:
        raise ValueError(
            f"irfft2: axis {a0} has {y.shape[a0]} bins, expected n0={n0}")
    return irfft(ifft(y, a0, norm), n1, a1, norm)


# ------------------------------------------------- split (re, im) API

def rfft_split(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """r2c FFT returning an (re, im) pair of real tensors."""
    norm = check_norm(norm)
    x = _as_real_plane(as_tensor(x), "rfft_split")
    _check_axis(x, axis)
    n = x.shape[axis]
    _check_length(n)
    yr, yi = core.srfft(x.movedim(axis, -1), n, fwd_scale(norm, n))
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


def irfft_split(yr, yi, n: int, axis: int = -1, norm: str = DEFAULT_NORM):
    """c2r inverse of an (re, im) packed-spectrum pair."""
    norm = check_norm(norm)
    n = int(n)
    yr = as_tensor(yr)
    yi = as_tensor(yi, like=yr)
    if yr.shape != yi.shape:
        raise ValueError("re/im shapes differ")
    yr = _as_real_plane(yr, "irfft_split")
    if yi.dtype != yr.dtype:
        yi = _as_real_plane(yi, "irfft_split").to(yr.dtype)
    _check_axis(yr, axis)
    if yr.shape[axis] != n // 2 + 1:
        raise ValueError(
            f"irfft_split: spectrum axis has {yr.shape[axis]} bins, "
            f"expected n//2+1 = {n // 2 + 1} for n={n}")
    x = core.sirfft(yr.movedim(axis, -1), yi.movedim(axis, -1), n,
                    inv_scale(norm, n))
    return x.movedim(-1, axis)


def rfft2_split(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D real FFT -> (re, im) pair of shape (..., n0, n1//2+1), with
    the row-column semantics of :func:`rfft2`."""
    norm = check_norm(norm)
    a0, a1 = (int(a) for a in axes)
    yr, yi = rfft_split(x, a1, norm)
    return fft_split(yr, yi, a0, norm)


def irfft2_split(yr, yi, s, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse of :func:`rfft2_split`; ``s = (n0, n1)`` is the real
    output shape (packed spectra are parity-ambiguous)."""
    norm = check_norm(norm)
    a0, a1 = (int(a) for a in axes)
    n0, n1 = int(s[0]), int(s[1])
    yr = as_tensor(yr)
    yi = as_tensor(yi, like=yr)
    if yr.shape[a0] != n0:
        raise ValueError(f"irfft2_split: axis {a0} has {yr.shape[a0]} "
                         f"bins, expected n0={n0}")
    if yr.shape[a1] != n1 // 2 + 1:
        raise ValueError(
            f"irfft2_split: axis {a1} has {yr.shape[a1]} bins, expected "
            f"n1//2+1 = {n1 // 2 + 1} for n1={n1}")
    zr, zi = ifft_split(yr, yi, a0, norm)
    return irfft_split(zr, zi, n1, a1, norm)


def rfilter_split(x, fr, fi, axis: int = -1, norm: str = DEFAULT_NORM):
    """Fused real spectral filter: irfft(rfft(x) * (fr + i*fi)).

    ``(fr, fi)`` is the packed (n//2+1)-bin filter spectrum.  Equal to
    the composition through ``rfft_split`` and ``irfft_split`` for every
    norm, but even n runs one half-length FFT, one fused FMA and one
    inverse, with no packed-spectrum merge or un-merge; float32 lengths
    of the stream kernels with an even flat batch and one filter run
    the streaming filter (K2 and K4, the norm's scale in K4's store)
    instead.  The filter's DC and (even n) Nyquist bins must be real, as
    for the rfft of a real filter.
    """
    norm = check_norm(norm)
    x = _as_real_plane(as_tensor(x), "rfilter_split")
    fr = _as_real_plane(as_tensor(fr, like=x), "rfilter_split").to(
        dtype=x.dtype, device=x.device)
    fi = _as_real_plane(as_tensor(fi, like=x), "rfilter_split").to(
        dtype=x.dtype, device=x.device)
    _check_axis(x, axis)
    n = x.shape[axis]
    _check_length(n)
    if fr.shape[-1] != n // 2 + 1 or fi.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"rfilter_split: filter must have n//2+1 = {n // 2 + 1} "
            f"packed bins, got {fr.shape[-1]}")
    s = fwd_scale(norm, n) * inv_scale(norm, n)
    return core.srfilter(x.movedim(axis, -1), fr, fi, n, s).movedim(-1, axis)
