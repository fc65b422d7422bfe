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
lane group, so the ragged width needs no pad).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import (DEFAULT_NORM, as_tensor, check_norm, complex_dtype_of,
                      fwd_scale, inv_scale, real_dtype_of)
from .. import plan
from ..utils.profiling import span
from . import core, fused_fft, stream_fft
from .cfft import (_apply_axis, _as_real_plane, _check_axis, _check_length,
                   _fft_impl, _fft_split_impl)

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
    return _fft_impl(rfft(x, a1, norm), a0, norm, inverse=False)


def irfft2(y, s, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse 2-D real FFT; ``s = (n0, n1)`` is the real output shape."""
    norm = check_norm(norm)
    a0, a1 = (int(a) for a in axes)
    n0, n1 = int(s[0]), int(s[1])
    y = as_tensor(y)
    if y.shape[a0] != n0:
        raise ValueError(
            f"irfft2: axis {a0} has {y.shape[a0]} bins, expected n0={n0}")
    return irfft(_fft_impl(y, a0, norm, inverse=True), n1, a1, norm)


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
    return _fft_split_impl(yr, yi, a0, norm, inverse=False)


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
    zr, zi = _fft_split_impl(yr, yi, a0, norm, inverse=True)
    return irfft_split(zr, zi, n1, a1, norm)


def _rfilter_tables(n: int):
    """Host tables c1..c4 (complex, h bins) for the fused real filter.

    Derivation: compose srfft's packed merge Y = Ze + w*Zo, the
    spectral multiply V = F*Y, and sirfft's un-merge Z' = (1+i*conj(w))V
    + (1-i*conj(w))*conj(V_mirror) into Z' = P*Z + Q*conj(Z_mirror)
    with P = c1*F + c3*conj(Fm), Q = c2*F + c4*conj(Fm): the filter
    then needs no packed (n/2+1)-bin spectrum at all.
    """
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    A = 1 + 1j * np.conj(w)
    B = 1 - 1j * np.conj(w)
    return (A * (1 - 1j * w) / 2, A * (1 + 1j * w) / 2,
            B * (1 + 1j * w) / 2, B * (1 - 1j * w) / 2)


def _rfilter_fused(x, fr, fi, n: int):
    """Fused filter body (even n): deinterleave -> one n/2 complex FFT
    -> one half-spectrum FMA -> inverse FFT -> interleave."""
    h = n // 2
    Zr, Zi = core.sfft(x[..., 0::2], x[..., 1::2], h, inverse=False)
    c1r, c1i, c2r, c2i, c3r, c3i, c4r, c4i = plan.device_tables(
        n, x.dtype, x.device).rfilter
    Fr, Fi = fr[..., :h], fi[..., :h]
    # conj(Fm): Fm_k = F_{h-k}, k = 0..h-1
    Fmr = fr[..., 1:].flip(-1)
    Fmi = -fi[..., 1:].flip(-1)
    Pr = c1r * Fr - c1i * Fi + c3r * Fmr - c3i * Fmi
    Pi = c1r * Fi + c1i * Fr + c3r * Fmi + c3i * Fmr
    Qr = c2r * Fr - c2i * Fi + c4r * Fmr - c4i * Fmi
    Qi = c2r * Fi + c2i * Fr + c4r * Fmi + c4i * Fmr

    def zmul(pr, pi, qr, qi, Ar, Ai, Br, Bi):
        # (pr+ipi)(Ar+iAi) + (qr+iqi)(Br-iBi)
        re = pr * Ar - pi * Ai + qr * Br + qi * Bi
        im = pr * Ai + pi * Ar + qi * Br - qr * Bi
        return re, im

    # Z' = P*Z + Q*conj(Zm); bin 0 is its own mirror
    Z0r, Z0i = zmul(Pr[..., :1], Pi[..., :1], Qr[..., :1], Qi[..., :1],
                    Zr[..., :1], Zi[..., :1], Zr[..., :1], Zi[..., :1])
    Zcr, Zci = zmul(Pr[..., 1:], Pi[..., 1:], Qr[..., 1:], Qi[..., 1:],
                    Zr[..., 1:], Zi[..., 1:], Zr[..., 1:].flip(-1),
                    Zi[..., 1:].flip(-1))
    wr, wi = core.sfft(torch.cat([Z0r, Zcr], dim=-1),
                       torch.cat([Z0i, Zci], dim=-1), h, inverse=True)
    with span("cfftpack.unpack"):
        return core._interleave(wr, wi)


def _use_stream_filter(x, fr, fi, n: int) -> bool:
    """The streaming filter's structural conditions: float32, a length
    the stream kernels take (split or not), one filter for every row,
    an even flat batch to pair, and a half length K1 does not take.

    The conjugate-symmetric extension assumes real DC and Nyquist bins
    (fi[0] == fi[n//2] == 0, the rfft of a real filter), the documented
    contract of ``rfilter_split``."""
    if not stream_fft.stream_filter_eligible(n, x.dtype):
        return False
    if fr.ndim != 1 or fi.ndim != 1:
        return False
    B = x.shape[:-1].numel()
    if B % 2 or B < 2:
        return False
    return not fused_fft.fused_eligible(n // 2, x.dtype)


def _rfilter_stream(x, fr, fi, n: int, scale: float):
    """Large-n filter times ``scale``: rows paired, K2 forward to the
    permuted spectrum, the multiply fused into K4's inverse and the scale
    into its store; no deinterleave, merge or interleave pass."""
    h = n // 2
    ffr = torch.cat([fr, fr[1:h].flip(-1)])
    ffi = torch.cat([fi, -fi[1:h].flip(-1)])
    return stream_fft.sfilter_stream(x, ffr, ffi, n, scale)


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
    x = x.movedim(axis, -1)
    s = fwd_scale(norm, n) * inv_scale(norm, n)
    if n % 2:
        # odd n: plain composition (no half-length packing to fuse)
        yr, yi = core.srfft(x, n)
        out = core.sirfft(yr * fr - yi * fi, yr * fi + yi * fr, n)
    elif _use_stream_filter(x, fr, fi, n):
        # the scale rides in the store of K4 (or K5 past the cap)
        return _rfilter_stream(x, fr, fi, n, s).movedim(-1, axis)
    else:
        out = _rfilter_fused(x, fr, fi, n)
    # the unscaled pipeline is sirfft(srfft(x)*F); the public
    # composition applies fwd_scale then inv_scale on top
    if s != 1.0:
        with span("cfftpack.scale"):
            out = out * s
    return out.movedim(-1, axis)
